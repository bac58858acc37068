"""CaiT's talking-heads attention from the qkv product's output to the
attention output before ``proj`` and the stored head map.

``talking_heads`` chooses its route by what the tensors show, with no
option: a CUDA bf16 qkv that needs no gradient, of head width 48 and 4 or
8 heads (every CaiT preset), goes to the hand-written kernel
(``kernels/talking_heads.py``, ``csrc/talking_heads.cu``: one launch,
counted ``launches.talking_heads``); every other call takes
``talking_heads_plain``, the eager chain (the CPU, training's autograd,
fp32 parity, other head counts), and on the card counts
``talking_heads.plain``. The kernel computes the chain's function with its
rounding points; only its fp32 sums run in another order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from protopformer_tpu_torch.kernels.talking_heads import (
    HEAD_DIM,
    HEADS,
    talking_heads_cuda,
)
from protopformer_tpu_torch.ops.rollout import _fuse_heads
from protopformer_tpu_torch.utils.profiling import count


def _mix_heads(a: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
               ) -> torch.Tensor:
    """Talking heads: a Linear(H, H) over the head axis of (B, H, N, M),
    with input, weight and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(a.permute(0, 2, 3, 1).to(dtype), layer.weight.to(dtype),
                    bias).permute(0, 3, 1, 2)


def talking_heads_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                        proj_l: nn.Linear, proj_w: nn.Linear, head_fusion: str,
                        map_dtype: torch.dtype, dtype: torch.dtype
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eager chain: q scaled in ``dtype`` before QK^T, ``proj_l`` mixes
    the heads of the logits and ``proj_w`` those of the fp32 softmax cast
    back, both in ``dtype``. Returns (out (B, N, C) before ``proj``, the
    mixed probabilities' heads fused in fp32 by ``head_fusion`` and stored
    in ``map_dtype``, detached)."""
    B, N, C3 = qkv.shape
    H, C = num_heads, C3 // 3
    q, k, v = qkv.reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
    q = q * scale
    logits = _mix_heads(torch.matmul(q, k.transpose(-1, -2)), proj_l, dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(dtype)
    probs = _mix_heads(probs, proj_w, dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, C)
    fmap = _fuse_heads(probs.detach().float(), head_fusion).to(map_dtype)
    return out, fmap


def talking_heads(qkv: torch.Tensor, num_heads: int, scale: float,
                  proj_l: nn.Linear, proj_w: nn.Linear, head_fusion: str,
                  map_dtype: torch.dtype, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``talking_heads_plain``'s function: the kernel for a CUDA bf16 qkv
    that needs no gradient, of head width 48 and 4 or 8 heads; else the
    plain chain."""
    if qkv.is_cuda:
        grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (qkv, proj_l.weight, proj_l.bias, proj_w.weight,
                      proj_w.bias))
        if (qkv.dtype == torch.bfloat16 and dtype == torch.bfloat16
                and not grad and num_heads in HEADS
                and qkv.shape[-1] == 3 * num_heads * HEAD_DIM):
            return talking_heads_cuda(qkv.contiguous(), scale, proj_l, proj_w,
                                      head_fusion, map_dtype)
        count("talking_heads.plain")
    return talking_heads_plain(qkv, num_heads, scale, proj_l, proj_w,
                               head_fusion, map_dtype, dtype)
