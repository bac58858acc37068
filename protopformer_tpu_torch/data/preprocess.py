"""Normalization constants and the normalization fold (port of
``protopformer_tpu/data/preprocess.py``), acting on the port's state dict
(patch-embed weight (D, 3, p, p))."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float RGB in [0, 1] -> normalized (NHWC)."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def fold_normalization_into_patch_embed(
    state_dict: Mapping[str, torch.Tensor],
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
    input_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Fold the per-channel normalization into the patch-embed conv:

        conv((a*x - m) / s; W) + b  ==  conv(x; W a/s) + (b - sum_chw W m/s)

    so the model consumes raw pixels (``input_scale=1/255`` for uint8).
    Every ``*patch_embed.proj.weight`` / ``.bias`` pair is folded in fp32;
    the other entries are passed through. The input is not modified.
    """
    mean = torch.as_tensor(np.asarray(mean, np.float32))
    std = torch.as_tensor(np.asarray(std, np.float32))
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith("patch_embed.proj.weight"):
            continue
        bias_key = key[: -len("weight")] + "bias"
        w = torch.as_tensor(state_dict[key]).float()
        b = torch.as_tensor(state_dict[bias_key]).float()
        ms = (mean / std).to(w.device)
        shift = torch.einsum("dchw,c->d", w, ms)
        out[key] = w * (input_scale / std).to(w.device)[None, :, None, None]
        out[bias_key] = b - shift
    return out
