"""Where the port's entry points run: CUDA unless the caller asks for the
CPU, and never a quiet fallback from the one to the other."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev
