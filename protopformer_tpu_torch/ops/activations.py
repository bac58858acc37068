"""GELU forms of the JAX package (``protopformer_tpu/ops/activations.py``).

``gelu_exact`` keeps the JAX package's Abramowitz & Stegun 7.1.26 erf
(max abs err 1.5e-7) rather than ``torch.erf``, so fp32 parity holds at
1e-6; ``gelu_speed`` is the tanh form the bf16 speed path uses.
Forward only.
"""

from __future__ import annotations

import torch


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """fp32 erf via Abramowitz & Stegun 7.1.26 (max abs err 1.5e-7)."""
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741
                                   + t * (-1.453152027 + t * 1.061405429)))
    )
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU with the A&S erf; computes fp32, returns ``x.dtype``."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + erf_as(xf * (2.0 ** -0.5)))).to(x.dtype)


def gelu_speed(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU for the bf16 speed path."""
    xf = x.float()
    inner = 0.7978845608028654 * (xf + 0.044715 * xf * xf * xf)
    return (xf * 0.5 * (1.0 + torch.tanh(inner))).to(x.dtype)
