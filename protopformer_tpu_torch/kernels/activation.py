"""The bf16 MLP's tanh GELU in one pass (``csrc/gelu.cu``).

Ports no TPU kernel: the JAX package's ``gelu_speed`` is plain jnp that XLA
fuses into one loop, where PyTorch runs its eager statement
(``ops/activations.py::gelu_speed_plain``, the plain version of this
kernel) as 11 fp32 launches over the hidden. ``gelu_tanh_cuda`` reads the
bf16 hidden once and writes the bf16 result once, with the same fp32
arithmetic in the same order, so its bits are the chain's.
``ops.activations.gelu_speed`` takes it for a CUDA bf16 tensor that needs
no gradient. It is not one of ``kernels.WRAPPERS`` (the ports of the JAX
kernels) and opens no span: its kernel's name shows in a device trace.
"""

from __future__ import annotations

import torch

from protopformer_tpu_torch.kernels import _build
from protopformer_tpu_torch.utils.profiling import count


def gelu_tanh_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gelu.cu`` on a contiguous bf16 CUDA tensor of any
    shape; returns a new tensor of its shape and dtype."""
    if not x.is_cuda:
        raise ValueError(f"gelu_tanh: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gelu_tanh: dtype {x.dtype} is not bf16")
    if not x.is_contiguous():
        raise ValueError("gelu_tanh: tensor must be contiguous")
    out = torch.empty_like(x)
    lib = _build.library()
    with _build.on_device(x.device) as stream:
        code = lib.ppf_gelu_tanh_bf16(x.data_ptr(), out.data_ptr(),
                                      x.numel(), stream)
    _build.check_launch("gelu_tanh", code)
    count("launches.gelu_tanh")
    return out
