"""GELU forms of the JAX package (``protopformer_tpu/ops/activations.py``).

``gelu_exact`` keeps the JAX package's Abramowitz & Stegun 7.1.26 erf
(max abs err 1.5e-7) rather than ``torch.erf``, so fp32 parity holds at
1e-6. Its backward is the analytic derivative Phi(x) + x * phi(x), the
JAX function's ``custom_jvp``, not autograd through the polynomial.
``gelu_speed`` is the tanh form the bf16 speed path uses, differentiated
by plain autograd as JAX differentiates it. It chooses its route by what
the tensor shows, with no option: a CUDA bf16 tensor that needs no
gradient goes to the hand-written pass (``kernels/activation.py``,
``csrc/gelu.cu``: one launch, counted ``launches.gelu_tanh``), which gives
the bits of ``gelu_speed_plain``, the eager fp32 chain; every other tensor
takes that chain (the CPU, training's autograd, other dtypes), and on the
card counts ``gelu.plain``.
"""

from __future__ import annotations

import torch

from protopformer_tpu_torch.kernels.activation import gelu_tanh_cuda
from protopformer_tpu_torch.utils.profiling import count


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


class _GeluExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        return (xf * 0.5 * (1.0 + erf_as(xf * (2.0 ** -0.5)))).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        xf = x.float()
        cdf = 0.5 * (1.0 + erf_as(xf * (2.0 ** -0.5)))
        pdf = torch.exp(-0.5 * xf * xf) * 0.3989422804014327  # 1/sqrt(2 pi)
        return (cdf + xf * pdf).to(x.dtype) * grad


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU with the A&S erf; computes fp32, returns ``x.dtype``."""
    return _GeluExact.apply(x)


def gelu_speed(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU for the bf16 speed path: the one-pass kernel
    for a CUDA bf16 tensor that needs no gradient, else the plain chain."""
    if x.is_cuda:
        if x.dtype == torch.bfloat16 and not (torch.is_grad_enabled()
                                              and x.requires_grad):
            return gelu_tanh_cuda(x.contiguous())
        count("gelu.plain")
    return gelu_speed_plain(x)


def gelu_speed_plain(x: torch.Tensor) -> torch.Tensor:
    """``gelu_speed`` as eager fp32 elementwise operations, computed in this
    order (``csrc/gelu.cu`` repeats it)."""
    xf = x.float()
    inner = 0.7978845608028654 * (xf + 0.044715 * xf * xf * xf)
    return (xf * 0.5 * (1.0 + torch.tanh(inner))).to(x.dtype)
