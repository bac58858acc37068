"""CaiT's talking-heads attention in one kernel (``csrc/talking_heads.cu``).

Ports no TPU kernel: the JAX package's ``TalkingHeadAttention`` is plain
jnp that XLA fuses, where PyTorch runs the port's eager chain
(``ops/talking_heads.py::talking_heads_plain``, the plain version of this
kernel) as some twenty launches over (B, H, N, N) tensors.
``talking_heads_cuda`` reads qkv in place and writes the attention output
and the stored head map once, with the chain's rounding points; only its
fp32 sums run in another order, so a bf16 rounding flips now and then.
``ops.talking_heads.talking_heads`` takes it for a CUDA bf16 qkv that needs
no gradient, of head width 48 and 4 or 8 heads. It is not one of
``kernels.WRAPPERS`` (the ports of the JAX kernels) and opens no span of
its own: ``TalkingHeadAttention``'s region span ``cait.talking_heads``
encloses it, and its kernel's name shows in a device trace.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from protopformer_tpu_torch.kernels import _build
from protopformer_tpu_torch.utils.profiling import count

HEAD_DIM = 48
HEADS = (4, 8)
FUSIONS = {"mean": 0, "max": 1, "min": 2}


def _param(p, name: str, shape, device) -> int:
    """The data pointer of an fp32 contiguous parameter of ``shape`` on
    ``device`` (0 for a missing bias)."""
    if p is None:
        return 0
    if p.dtype != torch.float32:
        raise TypeError(f"talking_heads: {name} dtype {p.dtype} is not fp32")
    if tuple(p.shape) != shape or not p.is_contiguous() or p.device != device:
        raise ValueError(f"talking_heads: {name} must be a contiguous {shape} "
                         f"tensor on {device}, got {tuple(p.shape)} on "
                         f"{p.device}")
    return p.data_ptr()


def talking_heads_cuda(qkv: torch.Tensor, scale: float, proj_l: nn.Linear,
                       proj_w: nn.Linear, head_fusion: str,
                       map_dtype: torch.dtype
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/talking_heads.cu`` on a contiguous bf16 CUDA qkv (B, N,
    3C) whose heads (``proj_l``'s H, 4 or 8) are 48 wide; ``scale`` is the
    bf16 value q is scaled by. Returns (out (B, N, C) bf16 before ``proj``,
    the map (B, N, N) in ``map_dtype``: the mixed probabilities' heads
    fused by ``head_fusion``)."""
    if not qkv.is_cuda:
        raise ValueError(f"talking_heads: expected a CUDA tensor, got "
                         f"{qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"talking_heads: qkv dtype {qkv.dtype} is not bf16")
    if not qkv.is_contiguous() or qkv.dim() != 3 or qkv.data_ptr() % 16:
        raise ValueError("talking_heads: qkv must be a contiguous, 16-byte "
                         "aligned (B, N, 3C) tensor")
    B, N, C3 = qkv.shape
    H = proj_l.weight.shape[0]
    if H not in HEADS:
        raise ValueError(f"talking_heads: {H} heads; the kernel takes "
                         f"{HEADS}")
    if C3 != 3 * H * HEAD_DIM:
        raise ValueError(f"talking_heads: head width {C3 / (3 * H)}; the "
                         f"kernel takes {HEAD_DIM}")
    if head_fusion not in FUSIONS:
        raise ValueError(f"talking_heads: unknown head_fusion {head_fusion!r}")
    if map_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"talking_heads: map dtype {map_dtype} is not bf16 "
                        f"or fp32")
    dev = qkv.device
    ptrs = [_param(layer.weight, f"{what}.weight", (H, H), dev)
            for what, layer in (("proj_l", proj_l), ("proj_w", proj_w))]
    biases = [_param(layer.bias, f"{what}.bias", (H,), dev)
              for what, layer in (("proj_l", proj_l), ("proj_w", proj_w))]
    out = torch.empty((B, N, C3 // 3), dtype=torch.bfloat16, device=dev)
    fmap = torch.empty((B, N, N), dtype=map_dtype, device=dev)
    lib = _build.library()
    with _build.on_device(dev) as stream:
        code = lib.ppf_talking_heads(
            qkv.data_ptr(), B, N, H, float(scale), ptrs[0], biases[0] or None,
            ptrs[1], biases[1] or None, FUSIONS[head_fusion],
            int(map_dtype == torch.float32), out.data_ptr(), fmap.data_ptr(),
            stream)
    _build.check_launch("talking_heads", code)
    count("launches.talking_heads")
    return out, fmap
