"""Transformer layers of the pruning forward (port of part of
``protopformer_tpu/models/layers.py``).

Module and parameter names follow the reference PyTorch layout
(``patch_embed.proj``, ``blocks.{i}.norm1``, ``attn.qkv``, ``attn.proj``,
``mlp.fc1``, ``mlp.fc2``), so a reference state dict loads with
``strict=True``. Parameters stay fp32; each product runs in the compute
dtype (bf16 speed or fp32 parity), LayerNorm statistics are fp32.

``Attention`` is the kernel-on structure of the JAX package
(``layers.py:418-465``):
  * a pre-prune block (``tap=True``) with the all-ones policy in bf16 runs
    K1 (``fused_attention_block_stats``) and returns the lazy-rollout
    triple (map, threshold, row sums);
  * every other block runs K3 (``fused_attention_mean_padded``) on the
    unpadded sequence and returns the raw fp32 head-mean map. The pad to a
    multiple of 128 tokens was the TPU's lane width and is not carried over.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from protopformer_tpu_torch.kernels.attention_core import (
    fused_attention_block_stats,
    fused_attention_mean_padded,
)
from protopformer_tpu_torch.ops.activations import gelu_exact, gelu_speed

Policy = Union[str, torch.Tensor]


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype
               ) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 affine, output in ``dtype``."""
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps
    ).to(dtype)


class PatchEmbed(nn.Module):
    """NHWC image -> (B, N, D) patch tokens by a strided conv."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        y = F.conv2d(
            x, self.proj.weight.to(self.dtype), self.proj.bias.to(self.dtype),
            stride=self.proj.stride,
        )
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> GELU (A&S exact-erf in fp32, tanh form in bf16) -> fc2."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dense(x, self.fc1, self.dtype)
        h = gelu_exact(h) if self.dtype == torch.float32 else gelu_speed(h)
        return dense(h, self.fc2, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention on the kernel-on structure.

    Args:
      rollout: (discard_ratio, exact_discard) of the lazy rollout; the
        exact flag selects K1's map storage dtype (fp32 exact, bf16 speed).
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype, rollout: Tuple[float, bool]):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.rollout = rollout
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, policy: Policy, tap: bool = True):
        """``policy`` is ``"ones"`` (static all-ones) or a (B, N) keep-mask.
        ``tap=False`` marks a block whose map is never consumed: K1 is
        skipped there, as in the JAX package.

        Returns (out (B, N, C), aux): aux is (map, t, s) after K1, else the
        raw fp32 (B, N, N) head-mean map.
        """
        B, N, _ = x.shape
        qkv = dense(x, self.qkv, self.dtype)
        if tap and isinstance(policy, str) and self.dtype != torch.float32:
            ratio, exact = self.rollout
            out, fmap, t, s = fused_attention_block_stats(
                qkv, self.num_heads, ratio, exact
            )
            return dense(out, self.proj, self.dtype), (fmap, t, s)
        if isinstance(policy, str):
            pol = torch.ones((B, N), dtype=torch.float32, device=x.device)
        else:
            pol = policy.reshape(B, N).float()
        out, fmap = fused_attention_mean_padded(
            qkv, pol, self.num_heads, real_n=N
        )
        return dense(out, self.proj, self.dtype), fmap


class Block(nn.Module):
    """Pre-LN transformer block returning (x, attention aux)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, layer_norm_eps: float, dtype: torch.dtype,
                 rollout: Tuple[float, bool]):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, rollout)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor, policy: Policy,
                tap: bool = True) -> Tuple[torch.Tensor, Optional[object]]:
        h, aux = self.attn(layer_norm(x, self.norm1, self.dtype), policy, tap)
        x = x + h
        x = x + self.mlp(layer_norm(x, self.norm2, self.dtype))
        return x, aux
