"""Transformer layers of the pruning forward (port of part of
``protopformer_tpu/models/layers.py``).

Module and parameter names follow the reference PyTorch layout
(``patch_embed.proj``, ``blocks.{i}.norm1``, ``attn.qkv``, ``attn.proj``,
``mlp.fc1``, ``mlp.fc2``), so a reference state dict loads with
``strict=True``. Parameters stay fp32; each product runs in the compute
dtype (bf16 speed or fp32 parity), LayerNorm statistics are fp32. The
configuration's other choices keep those keys: ``QuantDense`` runs a
block's four products int8 (``quantize="int8"``), ``FastLayerNorm`` and
``MxuLayerNorm`` take a bf16 block's LayerNorm statistics in the compute
dtype or as products with a 1/C vector (``ln_stats``), and ``PatchEmbed``
states the patch conv as an unfold and one product (``patch_embed``).

In eval mode, with a policy and the kernels on, ``Attention`` is the
kernel-on structure of the JAX package (``layers.py:418-465``):
  * a pre-prune block (``tap=True``) with the all-ones policy in bf16 runs
    K1 (``fused_attention_block_stats``) and returns the lazy-rollout
    triple (map, threshold, row sums);
  * a block whose map is consumed normalized (``normalized=True``, the
    eager rollout of ``DeiTBackbone.masked_forward_thresh``) runs K4
    (``fused_attention_core``) with exact discard, or K3 followed by the
    plain ``normalize_attention_map`` with the 16-bit prefix discard (K4
    is exact only), and returns the normalized fp32 map;
  * every other block runs K3 (``fused_attention_mean_padded``) on the
    unpadded sequence and returns the raw fp32 head-mean map. The pad to a
    multiple of 128 tokens was the TPU's lane width and is not carried over.
The kernels have no backward (nor do the JAX package's), so an eval-mode
forward that would record gradients raises. Every other forward runs the
JAX package's per-head loop (``layers.py:469-490``, its ``fuse_probs``
headloop): per-head products, ``eps_softmax`` under the all-ones policy,
``softmax_with_policy`` after a prune and, with no policy (the unpruned
forwards, ``layers.py:549-551``), a plain softmax over fp32 logits cast
back to the compute dtype. Under "mean" head fusion the map is accumulated
as sum_h probs_h * (1/H) in fp32 in head order; under "max"/"min" the
per-head probabilities are returned; either is detached. The headloop
runs in training mode (the JAX package's ``deterministic=False``, which
its kernel gate excludes), in the kernel-off eval structure
(``use_pallas="off"``, or "max"/"min" fusion, which the kernels' head mean
cannot serve) and without a policy. Dropout (``drop_rate``) follows the
attention projection and each MLP product, and ``DropPath`` each residual
branch, in training mode; both draw from the ``torch.Generator`` the
caller passes down.

CaiT's blocks (``layers.py:635-829`` of the JAX package) run plain PyTorch
products, as the JAX package runs them outside any Pallas kernel:
``TalkingHeadAttention`` mixes the heads before and after its softmax, so
its maps are not probabilities; ``ClassAttention`` attends from the CLS
row only; the LayerScale blocks scale each residual branch by fp32 gammas
cast to the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from protopformer_tpu_torch.kernels.attention_core import (
    fused_attention_block_stats,
    fused_attention_core,
    fused_attention_mean_padded,
)
from protopformer_tpu_torch.ops.activations import gelu_exact, gelu_speed
from protopformer_tpu_torch.ops.masking import (
    class_attn_softmax_with_policy,
    eps_softmax,
    softmax_with_policy,
)
from protopformer_tpu_torch.ops.quant import int8_matmul
from protopformer_tpu_torch.ops.rollout import _fuse_heads, normalize_attention_map

Policy = Union[str, torch.Tensor]
Generator = Optional[torch.Generator]


class QuantDense(nn.Linear):
    """A ``Linear`` whose product runs on the int8 path (``ops/quant.py``):
    the same ``weight``/``bias`` parameters and state-dict keys, fp32; only
    the serving product is quantized (weights per column, activations per
    row, both dynamic). The fp32 result plus the fp32 bias is cast to the
    compute dtype. It has no backward (an int8 product)."""

    def int8(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.weight.requires_grad):
            raise RuntimeError(
                "quantize='int8' is a serving mode: its int8 product has no "
                "backward; run it under torch.no_grad()/inference_mode()"
            )
        y = int8_matmul(x.to(dtype), self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return y.to(dtype)


def linear(dim_in: int, dim_out: int, quant: bool = False, bias: bool = True
           ) -> nn.Linear:
    """``QuantDense`` under int8 serving, else ``nn.Linear``."""
    return (QuantDense if quant else nn.Linear)(dim_in, dim_out, bias=bias)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias in ``dtype`` (a
    ``QuantDense`` runs its int8 product)."""
    if isinstance(layer, QuantDense):
        return layer.int8(x, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class FastLayerNorm(nn.LayerNorm):
    """LayerNorm with compute-dtype statistics (the JAX package's
    ``ln_stats="compute"``): the mean and E[x^2] of x in the compute dtype,
    each a mean rounded once to that dtype, then the variance, rsqrt,
    normalize and affine in it. ``nn.LayerNorm``'s parameters and keys."""

    def stats_norm(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xs = x.to(dtype)
        mu = xs.float().mean(dim=-1, keepdim=True).to(dtype)
        msq = (xs * xs).float().mean(dim=-1, keepdim=True).to(dtype)
        inv = torch.rsqrt(msq - mu * mu + torch.tensor(self.eps, dtype=dtype))
        y = (xs - mu) * inv
        return y * self.weight.to(dtype) + self.bias.to(dtype)


class MxuLayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics are products with a 1/C vector (the JAX
    package's ``ln_stats="mxu"``): mean and E[x^2] as fp32-accumulated sums
    of x and of x*x (both in the compute dtype) times 1/C rounded to the
    compute dtype; variance and rsqrt in fp32; the mean and inverse rounded
    to the compute dtype for the normalize and affine.
    ``nn.LayerNorm``'s parameters and keys."""

    def stats_norm(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xs = x.to(dtype)
        w = float(torch.tensor(1.0 / xs.shape[-1], dtype=dtype))
        mu = (xs.float() * w).sum(dim=-1, keepdim=True)
        msq = ((xs * xs).float() * w).sum(dim=-1, keepdim=True)
        inv = torch.rsqrt(msq - mu * mu + self.eps)
        y = (xs - mu.to(dtype)) * inv.to(dtype)
        return y * self.weight.to(dtype) + self.bias.to(dtype)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype
               ) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 affine, output in ``dtype``
    (a ``FastLayerNorm``/``MxuLayerNorm`` takes its own statistics)."""
    if isinstance(norm, (FastLayerNorm, MxuLayerNorm)):
        return norm.stats_norm(x, dtype)
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps
    ).to(dtype)


def block_norm(dim: int, eps: float, ln_stats: str, dtype: torch.dtype
               ) -> nn.LayerNorm:
    """A block's LayerNorm as the JAX package's ``Block`` picks it: the
    compute-dtype or product statistics only when ``ln_stats`` asks for
    them and the compute dtype is not fp32."""
    if dtype != torch.float32 and ln_stats == "compute":
        return FastLayerNorm(dim, eps=eps)
    if dtype != torch.float32 and ln_stats == "mxu":
        return MxuLayerNorm(dim, eps=eps)
    return nn.LayerNorm(dim, eps=eps)


def dropout(x: torch.Tensor, rate: float, generator: Generator,
            per_sample: bool = False) -> torch.Tensor:
    """Zero each entry with probability ``rate`` and scale the rest by
    1/(1 - rate) (flax ``nn.Dropout``); ``per_sample``: one draw per
    leading index, stochastic depth (timm ``DropPath``)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = ((x.shape[0],) + (1,) * (x.dim() - 1)) if per_sample else x.shape
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


@torch.no_grad()
def seeded_init_(model: nn.Module, features: nn.Module, arch: str,
                 init_scale: float, generator: torch.Generator) -> None:
    """Seeded random weights for ``model`` over the backbone ``features``:
    PyTorch's default Linear/Conv2d init (U(+-1/sqrt(fan_in))), LayerNorm
    ones/zeros, the CLS token, the distillation token (if any) and the
    position embedding N(0, 0.02^2). A CaiT backbone's linears take the
    JAX package's flax init instead (N(0, 1/fan_in), zero bias): talking
    heads mix probabilities of about 1/N, which a default bias of up to
    1/sqrt(num_heads) would swamp. Its LayerScale gammas start at
    ``init_scale``."""
    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = m.weight[0].numel() ** -0.5
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    for name in ("cls_token", "dist_token", "pos_embed"):
        p = getattr(features, name, None)
        if p is not None:
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    if arch == "cait":
        for m in features.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.weight.shape[1] ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        for name, p in features.named_parameters():
            if name.endswith(("gamma_1", "gamma_2")):
                p.fill_(init_scale)


class DropPath(nn.Module):
    """Stochastic depth on a residual branch, in training mode only."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, generator, per_sample=True)


class PatchEmbed(nn.Module):
    """NHWC image -> (B, N, D) patch tokens by a strided conv, or with
    ``impl="matmul"`` (the JAX package's ``_PatchProj``) by the same
    function stated as an unfold and one product over the conv's own
    parameters, ordered (kh, kw, in)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32, impl: str = "conv"):
        super().__init__()
        self.dtype = dtype
        self.impl = impl
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.impl == "matmul":
            B, H, W, C = x.shape
            p = self.proj.stride[0]
            gh, gw = H // p, W // p
            patches = x.reshape(B, gh, p, gw, p, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * C)
            w = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * C, -1)
            return torch.matmul(patches.to(dt), w.to(dt)) \
                + self.proj.bias.to(dt)
        x = x.permute(0, 3, 1, 2).to(dt)
        y = F.conv2d(
            x, self.proj.weight.to(dt), self.proj.bias.to(dt),
            stride=self.proj.stride,
        )
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> GELU (A&S exact-erf in fp32, tanh form in bf16) -> fc2, each
    product followed by dropout in training mode."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype,
                 drop_rate: float = 0.0, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.fc1 = linear(dim, hidden, quant)
        self.fc2 = linear(hidden, dim, quant)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        rate = self.drop_rate if self.training else 0.0
        h = dense(x, self.fc1, self.dtype)
        h = gelu_exact(h) if self.dtype == torch.float32 else gelu_speed(h)
        h = dropout(h, rate, generator)
        return dropout(dense(h, self.fc2, self.dtype), rate, generator)


class Attention(nn.Module):
    """Multi-head self-attention: the kernel structure or the headloop.

    Args:
      rollout: (discard_ratio, identity_weight, exact_discard) of the
        rollout; the exact flag selects K1's map storage dtype (fp32 exact,
        bf16 speed) and the discard of a normalized map.
      drop_rate: dropout after the output projection (training mode).
      head_fusion: the rollout's head fusion; under "mean" the map is the
        fp32 head mean, under "max"/"min" the headloop returns the
        per-head probabilities, which the consumer fuses.
      kernels: the eval forward takes the kernel structure (``use_pallas``
        "on"/"auto" under "mean" fusion); else the headloop.
      quant: ``qkv`` and ``proj`` are ``QuantDense`` (int8 serving).
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype, rollout: Tuple[float, float, bool],
                 drop_rate: float = 0.0, head_fusion: str = "mean",
                 kernels: bool = True, quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.rollout = rollout
        self.drop_rate = drop_rate
        self.head_fusion = head_fusion
        self.kernels = kernels and head_fusion == "mean"
        self.qkv = linear(dim, dim * 3, quant, bias=qkv_bias)
        self.proj = linear(dim, dim, quant)

    def forward(self, x: torch.Tensor, policy: Policy, tap: bool = True,
                normalized: bool = False, generator: Generator = None):
        """``policy`` is ``"ones"`` (static all-ones), a (B, N) keep-mask,
        or None (no pruning: a plain fp32 softmax, no map, no kernel).
        ``tap=False`` marks a block whose lazy-rollout triple is not
        consumed: K1 is skipped there, as in the JAX package.
        ``normalized=True`` asks for the normalized rollout map.

        Returns (out (B, N, C), aux): aux is (map, t, s) after K1, the
        normalized fp32 (B, N, N) map under ``normalized``, else the raw
        map: fp32 (B, N, N) head mean, or the (B, H, N, N) per-head
        probabilities in the compute dtype under "max"/"min" fusion; None
        without a policy. Maps carry no gradient.
        """
        if self.training or policy is None or not self.kernels:
            return self._headloop(x, policy, normalized, generator)
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                "the attention kernels have no backward: run the forward "
                "under torch.no_grad()/inference_mode(), or differentiate "
                "the training-mode forward (module.train())"
            )
        B, N, _ = x.shape
        qkv = dense(x, self.qkv, self.dtype)
        ratio, identity_weight, exact = self.rollout
        ones = isinstance(policy, str)
        if tap and ones and self.dtype != torch.float32:
            out, fmap, t, s = fused_attention_block_stats(
                qkv, self.num_heads, ratio, exact
            )
            return dense(out, self.proj, self.dtype), (fmap, t, s)
        pol = None if ones else policy.reshape(B, N).float()
        if normalized and exact:
            out, norm = fused_attention_core(
                qkv, pol, self.num_heads, ratio, identity_weight
            )
            return dense(out, self.proj, self.dtype), norm
        if pol is None:
            pol = torch.ones((B, N), dtype=torch.float32, device=x.device)
        out, fmap = fused_attention_mean_padded(
            qkv, pol, self.num_heads, real_n=N
        )
        if normalized:
            fmap = normalize_attention_map(fmap, ratio, identity_weight,
                                           exact_discard=False)
        return dense(out, self.proj, self.dtype), fmap

    def _headloop(self, x: torch.Tensor, policy: Optional[Policy],
                  normalized: bool, generator: Generator):
        """The JAX package's per-head loop in plain PyTorch (its
        ``fuse_probs`` headloop under "mean" fusion, the per-head
        probabilities of its plain path otherwise). Differentiable; the
        map is detached."""
        B, N, C = x.shape
        H, dt = self.num_heads, self.dtype
        hd = C // H
        qkv = dense(x, self.qkv, dt)
        scale = _scale(hd, dt)
        fuse = self.head_fusion == "mean"
        fmap = (torch.zeros((B, N, N), dtype=torch.float32, device=x.device)
                if fuse else None)
        outs, per_head = [], []
        for h in range(H):
            q = qkv[:, :, h * hd:(h + 1) * hd]
            k = qkv[:, :, C + h * hd:C + (h + 1) * hd]
            v = qkv[:, :, 2 * C + h * hd:2 * C + (h + 1) * hd]
            logits = torch.matmul(q, k.transpose(1, 2)) * scale
            if policy is None:
                probs = torch.softmax(logits.float(), dim=-1).to(dt)
            elif isinstance(policy, str):
                probs = eps_softmax(logits)
            else:
                probs = softmax_with_policy(logits[:, None], policy)[:, 0]
            if policy is not None and fuse:
                fmap = fmap + probs.detach().float() * (1.0 / H)
            elif policy is not None:
                per_head.append(probs.detach())
            outs.append(torch.matmul(probs, v))
        out = dense(torch.cat(outs, dim=-1), self.proj, dt)
        if policy is None:
            fmap = None
        elif not fuse:
            fmap = torch.stack(per_head, dim=1)
        if normalized:
            ratio, identity_weight, exact = self.rollout
            if fmap.dim() == 4:
                fmap = _fuse_heads(fmap.float(), self.head_fusion)
            fmap = normalize_attention_map(fmap, ratio, identity_weight,
                                           exact_discard=exact)
        if self.training:
            out = dropout(out, self.drop_rate, generator)
        return out, fmap


class Block(nn.Module):
    """Pre-LN transformer block returning (x, attention aux); in training
    mode each residual branch goes through ``DropPath(drop_path)``.
    ``quant``: its four products run int8 (``QuantDense``); ``ln_stats``:
    its two LayerNorms as ``block_norm`` picks them."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, layer_norm_eps: float, dtype: torch.dtype,
                 rollout: Tuple[float, float, bool], drop_rate: float = 0.0,
                 drop_path: float = 0.0, head_fusion: str = "mean",
                 kernels: bool = True, quant: bool = False,
                 ln_stats: str = "fp32"):
        super().__init__()
        self.dtype = dtype
        self.norm1 = block_norm(dim, layer_norm_eps, ln_stats, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, rollout,
                              drop_rate, head_fusion, kernels, quant)
        self.norm2 = block_norm(dim, layer_norm_eps, ln_stats, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate, quant)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, policy: Optional[Policy],
                tap: bool = True, normalized: bool = False,
                generator: Generator = None
                ) -> Tuple[torch.Tensor, Optional[object]]:
        h, aux = self.attn(layer_norm(x, self.norm1, self.dtype), policy, tap,
                           normalized, generator)
        x = x + self.drop_path1(h, generator)
        h = self.mlp(layer_norm(x, self.norm2, self.dtype), generator)
        return x + self.drop_path2(h, generator), aux


def _scale(head_dim: int, dtype: torch.dtype) -> float:
    """``head_dim ** -0.5`` rounded to ``dtype``, as the JAX package's
    weakly typed constant is before it multiplies q."""
    return float(torch.tensor(head_dim ** -0.5, dtype=dtype))


def _mix_heads(a: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
               ) -> torch.Tensor:
    """Talking heads: a Linear(H, H) over the head axis of (B, H, N, M)."""
    return dense(a.permute(0, 2, 3, 1), layer, dtype).permute(0, 3, 1, 2)


class TalkingHeadAttention(nn.Module):
    """CaiT self-attention with talking heads: q scaled before QK^T,
    ``proj_l`` mixes the heads of the logits and ``proj_w`` those of the
    fp32 softmax cast back, both in the compute dtype.

    Returns (out (B, N, C), the fp32 head mean (B, N, N) of the mixed
    probabilities, or under "max"/"min" ``head_fusion`` the mixed
    per-head probabilities (B, H, N, N) in the compute dtype): rows need
    not sum to 1, and entries may be negative.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype, drop_rate: float = 0.0,
                 head_fusion: str = "mean"):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.head_fusion = head_fusion
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.proj_l = nn.Linear(num_heads, num_heads)
        self.proj_w = nn.Linear(num_heads, num_heads)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, C = x.shape
        H, dt = self.num_heads, self.dtype
        qkv = dense(x, self.qkv, dt).reshape(B, N, 3, H, C // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q * _scale(C // H, dt)
        logits = _mix_heads(torch.matmul(q, k.transpose(-1, -2)),
                            self.proj_l, dt)
        probs = torch.softmax(logits.float(), dim=-1).to(dt)
        probs = _mix_heads(probs, self.proj_w, dt)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, C)
        out = dense(out, self.proj, dt)
        if self.training:
            out = dropout(out, self.drop_rate, generator)
        if self.head_fusion != "mean":
            return out, probs.detach()
        return out, probs.detach().float().mean(dim=1)


class ClassAttention(nn.Module):
    """CaiT class attention: separate q/k/v, the query from the CLS row
    only. Without a policy the softmax is a plain fp32 one; with a policy
    it is ``class_attn_softmax_with_policy``.

    Returns (out (B, 1, C), probabilities (B, H, 1, N) in the compute
    dtype)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.k = nn.Linear(dim, dim, bias=qkv_bias)
        self.v = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, policy: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, C = x.shape
        H, dt = self.num_heads, self.dtype

        def heads(t):
            return t.reshape(B, -1, H, C // H).transpose(1, 2)

        q = heads(dense(x[:, :1], self.q, dt)) * _scale(C // H, dt)
        k = heads(dense(x, self.k, dt))
        v = heads(dense(x, self.v, dt))
        logits = torch.matmul(q, k.transpose(-1, -2))
        if policy is None:
            probs = torch.softmax(logits.float(), dim=-1).to(dt)
        else:
            probs = class_attn_softmax_with_policy(logits, policy)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, 1, C)
        return dense(out, self.proj, dt), probs


class LayerScaleBlock(nn.Module):
    """CaiT self-attention block: pre-LN talking-heads attention and MLP,
    each branch scaled by its LayerScale gamma and, in training mode, put
    through ``DropPath(drop_path)``. Returns (x, the detached map of
    ``TalkingHeadAttention``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, init_values: float, layer_norm_eps: float,
                 dtype: torch.dtype, drop_rate: float = 0.0,
                 drop_path: float = 0.0, head_fusion: str = "mean"):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.attn = TalkingHeadAttention(dim, num_heads, qkv_bias, dtype,
                                         drop_rate, head_fusion)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, fmap = self.attn(layer_norm(x, self.norm1, self.dtype), generator)
        x = x + self.drop_path1(self.gamma_1.to(h.dtype) * h, generator)
        h = self.mlp(layer_norm(x, self.norm2, self.dtype), generator)
        h = self.drop_path2(self.gamma_2.to(h.dtype) * h, generator)
        return x + h, fmap


class LayerScaleBlockClassAttn(nn.Module):
    """CaiT class-attention block: updates the CLS token (B, 1, C) from
    [CLS; patches]. Returns (x_cls, per-head probabilities)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, init_values: float, layer_norm_eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.attn = ClassAttention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x: torch.Tensor, x_cls: torch.Tensor,
                policy: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        u = torch.cat([x_cls, x], dim=1)
        h, probs = self.attn(layer_norm(u, self.norm1, self.dtype), policy)
        x_cls = x_cls + self.gamma_1.to(h.dtype) * h
        h = self.mlp(layer_norm(x_cls, self.norm2, self.dtype))
        return x_cls + self.gamma_2.to(h.dtype) * h, probs
