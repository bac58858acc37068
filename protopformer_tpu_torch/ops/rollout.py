"""Attention rollout (port of ``protopformer_tpu/ops/rollout.py``).

Lazy: the pruning forward keeps, per pre-prune block, the RAW head-fused
map F, its discard threshold t (the keep-th largest value of the flattened
map) and the masked row sums s; the CLS row of the rollout product then
follows from ``rollout_row_scores_lazy`` without materializing a
normalized map.

Eager: ``normalize_attention_map`` materializes the normalized map (discard,
identity blend, row normalize), and ``rollout_row_scores`` /
``rollout_step`` / ``attn_rollout`` multiply such maps. Every rollout
product is an fp32 ``torch.matmul`` (the JAX package's
``Precision.HIGHEST``); on the card that needs TF32 off for matmuls,
PyTorch's default.

The k-th largest of a non-negative float map is found by bisection on its
bit pattern (value order equals integer order for non-negative floats);
the bit casts are ``Tensor.view(torch.int32)`` / ``view(torch.int16)``.
CaiT's talking-heads maps are not probabilities (whole maps can be
negative), so their search runs in a signed key space that orders every
finite float (``_monotone_keys_i32``). Every threshold here equals the JAX
package's bit for bit. On the card a signed search of a whole square map
runs the hand-written radix select in that order instead
(``kernels/stats.py::signed_map_stats_cuda``, counted
``launches.signed_map_stats``), with the same thresholds
(``signed_kernel_takes``); the chain stays the CPU's route and that of
sampled counts and padded maps, and counts ``signed_stats.plain`` on the
card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from protopformer_tpu_torch.utils.profiling import count


def _fuse_heads(attn: torch.Tensor, head_fusion: str) -> torch.Tensor:
    """(B, H, M, N) -> (B, M, N)."""
    if head_fusion == "mean":
        return attn.mean(dim=1)
    if head_fusion == "max":
        return attn.amax(dim=1)
    if head_fusion == "min":
        return attn.amin(dim=1)
    raise ValueError(f"unknown head_fusion: {head_fusion}")


def _static_bracket(bound, to_bits):
    """(lo0, hi0, iters) in the searched integer space from a float upper
    bound or a (lo, hi) float bracket of the k-th largest value."""
    if isinstance(bound, tuple):
        lo_f, hi_f = bound
        lo0 = to_bits(lo_f)
        hi0 = to_bits(hi_f)
    else:
        lo0 = 0
        hi0 = to_bits(bound)
    return lo0, hi0, (hi0 - lo0 + 1).bit_length()


def _f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


def _bf16_bits(v: float) -> int:
    # round to fp32 first, then to bf16, as the JAX package does
    f32 = float(np.float32(v))
    return int(torch.tensor(f32, dtype=torch.bfloat16).view(torch.int16))


def bisect_threshold(keys: torch.Tensor, keep: int, lo: torch.Tensor,
            hi: torch.Tensor, iters: int) -> torch.Tensor:
    """Largest key value v with count(keys >= v) >= keep, per batch row.
    ``keys`` is (B, E); lo/hi are (B,) in the keys' dtype or a wider
    integer dtype (every mid lies in [lo, hi], so it fits the keys')."""
    for _ in range(iters):
        mid = lo + torch.div(hi - lo + 1, 2, rounding_mode="floor")
        ok = (keys >= mid.to(keys.dtype)[:, None]).sum(dim=1) >= keep
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return lo


def kth_largest(flat: torch.Tensor, keep: int, bound=None) -> torch.Tensor:
    """Exact keep-th largest per row of a NON-NEGATIVE fp32 (B, ...)."""
    bits = flat.float().contiguous().view(torch.int32).reshape(flat.shape[0], -1)
    B = bits.shape[0]
    if bound is not None:
        lob, hib, iters = _static_bracket(bound, _f32_bits)
        lo = torch.full((B,), lob, dtype=torch.int32, device=bits.device)
        hi = torch.full((B,), hib, dtype=torch.int32, device=bits.device)
    else:
        lo = torch.zeros((B,), dtype=torch.int32, device=bits.device)
        hi = bits.amax(dim=1)
        iters = 31
    return bisect_threshold(bits, keep, lo, hi, iters).view(torch.float32)


def kth_largest_prefix16(flat: torch.Tensor, keep: int, bound: float = None
                         ) -> torch.Tensor:
    """bf16-prefix threshold (speed mode): bisects the high 16 bits of the
    fp32 pattern; returns the 16-bit floor of the exact k-th value."""
    bits = flat.float().contiguous().view(torch.int32).reshape(flat.shape[0], -1)
    bits = bits >> 16
    B = bits.shape[0]
    if bound is not None:
        lob, hib, iters = _static_bracket(
            bound, lambda v: _f32_bits(v) >> 16
        )
        lo = torch.full((B,), lob, dtype=torch.int32, device=bits.device)
        hi = torch.full((B,), hib, dtype=torch.int32, device=bits.device)
    else:
        lo = torch.zeros((B,), dtype=torch.int32, device=bits.device)
        hi = bits.amax(dim=1)
        iters = 15
    lo = bisect_threshold(bits, keep, lo, hi, iters)
    return (lo << 16).view(torch.float32)


def kth_largest_bf16(flat: torch.Tensor, keep: int, bound: float = None
                     ) -> torch.Tensor:
    """Exact k-th largest of a NON-NEGATIVE bf16 (B, ...) on its int16
    pattern; returns bf16."""
    bits = flat.contiguous().view(torch.int16).reshape(flat.shape[0], -1)
    B = bits.shape[0]
    if bound is not None:
        lob, hib, iters = _static_bracket(bound, _bf16_bits)
        lo = torch.full((B,), lob, dtype=torch.int16, device=bits.device)
        hi = torch.full((B,), hib, dtype=torch.int16, device=bits.device)
    else:
        lo = torch.zeros((B,), dtype=torch.int16, device=bits.device)
        hi = bits.amax(dim=1)
        iters = 15
    return bisect_threshold(bits, keep, lo, hi, iters).view(torch.bfloat16)


def _monotone_keys_i32(flat: torch.Tensor) -> torch.Tensor:
    """fp32 -> int32 keys whose signed order equals float order for every
    finite value: non-negative floats keep their bits, negative ones flip
    all but the sign bit. Each key is the JAX package's
    ``_monotone_keys_u32`` key minus 2^31 (PyTorch has no uint32
    arithmetic)."""
    bits = flat.float().contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _key_to_f32(key: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_monotone_keys_i32`` (the flip is an involution)."""
    key = key.to(torch.int32)
    return torch.where(key >= 0, key, key ^ 0x7FFFFFFF).view(torch.float32)


def _signed_bracket(keys: torch.Tensor):
    """Per-row (min, max) of (B, E) keys, in int64: over the whole fp32 key
    range hi - lo + 1 overflows int32."""
    return keys.amin(dim=1).long(), keys.amax(dim=1).long()


def kth_largest_signed(flat: torch.Tensor, keep: int, bound=None
                       ) -> torch.Tensor:
    """Exact keep-th largest per row of a MIXED-SIGN fp32 (B, ...): the
    bisection of the signed key space over its min/max bracket, 32
    passes. Static bounds assume non-negative maps and are rejected."""
    if bound is not None:
        raise ValueError("static bounds assume non-negative maps")
    keys = _monotone_keys_i32(flat).reshape(flat.shape[0], -1)
    lo, hi = _signed_bracket(keys)
    return _key_to_f32(bisect_threshold(keys, keep, lo, hi, 32))


def kth_largest_bf16_signed(flat: torch.Tensor, keep: int, bound=None
                            ) -> torch.Tensor:
    """Exact keep-th largest of a MIXED-SIGN bf16 (B, ...) in the 16-bit
    signed key space, 16 passes; returns bf16."""
    if bound is not None:
        raise ValueError("static bounds assume non-negative maps")
    bits = flat.contiguous().view(torch.int16).reshape(flat.shape[0], -1)
    keys = torch.where(bits >= 0, bits, bits ^ 0x7FFF)
    lo, hi = _signed_bracket(keys)
    key = bisect_threshold(keys, keep, lo, hi, 16).to(torch.int16)
    return torch.where(key >= 0, key, key ^ 0x7FFF).view(torch.bfloat16)


def signed_kernel_takes(fmap: torch.Tensor, sample: int = 1,
                        keep_elements: int = None) -> bool:
    """Whether ``masked_map_stats(signed=True)`` runs the hand-written
    signed select on ``fmap``: a square (B, N, N) fp32 or bf16 CUDA map,
    searched whole (no sampled counts) with no padding. Every other signed
    search runs the bisection chain."""
    return (fmap.is_cuda and sample == 1 and keep_elements is None
            and fmap.dim() == 3 and fmap.shape[1] == fmap.shape[2]
            and fmap.dtype in (torch.float32, torch.bfloat16))


def signed_search_passes(fmap: torch.Tensor, exact_discard: bool,
                         sample: int = 1) -> int:
    """The passes over ``fmap`` of its signed search: the kernel's cluster
    passes (2 on a bf16 map's 16-bit keys in speed mode, else 4 on 32-bit
    keys) or the chain's bisection steps (16, else 32)."""
    key16 = fmap.dtype == torch.bfloat16 and not exact_discard
    if signed_kernel_takes(fmap, sample):
        return 2 if key16 else 4
    return 16 if key16 else 32


def masked_map_stats(
    attn_fused: torch.Tensor,
    discard_ratio: float = 0.9,
    exact_discard: bool = True,
    keep_elements: int = None,
    value_bound: float = None,
    sample: int = 1,
    stochastic_eps: float = None,
    signed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discard threshold + masked row sums of one (B, M, N) fused map.

    Same contract as the JAX function: t (B,) in the map dtype (bf16 maps
    in speed mode, else fp32; -inf when discard is off), s (B, M) fp32.
    ``signed``: the map may hold negative values (CaiT's talking-heads
    maps), so the search runs in the signed key space (fp32: exact in
    both discard modes); ``value_bound`` and ``stochastic_eps`` assume
    probability maps and are rejected, ``sample`` composes. A signed
    search that ``signed_kernel_takes`` runs the hand-written kernel.
    """
    B, M, N = attn_fused.shape
    if signed and (value_bound is not None or stochastic_eps is not None):
        raise ValueError(
            "signed maps are not probabilities: value_bound/stochastic_eps"
            " do not apply"
        )
    if attn_fused.dtype == torch.bfloat16 and not exact_discard:
        a = attn_fused
        kth_fn = kth_largest_bf16_signed if signed else kth_largest_bf16
    else:
        a = attn_fused.float()
        if signed:
            kth_fn = kth_largest_signed
        else:
            kth_fn = kth_largest if exact_discard else kth_largest_prefix16
    real = keep_elements if keep_elements is not None else M * N
    keep = real - int(real * discard_ratio)

    def _bound_for(keep_count):
        if stochastic_eps is None or keep_elements is not None:
            return value_bound
        floor = stochastic_eps / N / (N + stochastic_eps) * 0.98
        cap = M / keep_count * 1.02
        if value_bound is not None:
            cap = min(cap, value_bound)
        return (floor, cap)

    if keep >= real:
        t = torch.full((B,), float("-inf"), dtype=torch.float32,
                       device=a.device)
        return t, a.float().sum(dim=-1)
    if signed and attn_fused.is_cuda:
        if signed_kernel_takes(attn_fused, sample, keep_elements):
            # imported here: the kernels package imports this module
            from protopformer_tpu_torch.kernels.stats import (
                signed_map_stats_cuda,
            )

            key16 = attn_fused.dtype == torch.bfloat16 and not exact_discard
            t, s = signed_map_stats_cuda(attn_fused.contiguous(), keep, key16)
            return (t.to(torch.bfloat16) if key16 else t), s
        count("signed_stats.plain")
    flat = a.reshape(B, -1)
    if sample > 1:
        if exact_discard:
            raise ValueError(
                "sampled discard counts are a speed-mode approximation;"
                " use sample=1 with exact_discard=True"
            )
        if keep_elements is not None:
            raise ValueError("sampled counts do not compose with padded maps")
        blk = 512
        ec = (flat.shape[1] // blk) * blk
        sub = flat[:, :ec].reshape(B, ec // blk, blk)[
            :, :, : blk // sample
        ].reshape(B, -1)
        keep_sub = max(1, round(keep * sub.shape[1] / real))
        t = kth_fn(sub, keep_sub, bound=_bound_for(keep_sub))
    else:
        t = kth_fn(flat, keep, bound=_bound_for(keep))
    af = a.float()
    s = torch.where(af >= t.float()[:, None, None], af, 0.0).sum(dim=-1)
    return t, s


def masked_map_stats_multi(
    fmaps: Sequence[torch.Tensor],
    discard_ratio: float = 0.9,
    exact_discard: bool = True,
    value_bound: float = None,
    sample: int = 1,
    stochastic_eps: float = None,
    signed: bool = False,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``masked_map_stats`` of a list of same-shape (B, M, N) maps by ONE
    search over the stacked (L*B) rows (``rollout_stats_batched="on"``).
    The search and the row sums are row-independent, so each layer's
    (t, s) equals its sequential ``masked_map_stats`` call bit for bit.
    Same arguments, minus ``keep_elements``."""
    t, s = masked_map_stats(
        torch.cat(list(fmaps)), discard_ratio, exact_discard,
        value_bound=value_bound, sample=sample,
        stochastic_eps=stochastic_eps, signed=signed,
    )
    B = fmaps[0].shape[0]
    return list(zip(t.split(B), s.split(B)))


def rollout_row_scores_lazy(
    fused_maps: Sequence[torch.Tensor],
    thresholds: Sequence[torch.Tensor],
    row_sums: Sequence[torch.Tensor],
    seed_row: torch.Tensor,
    identity_weight: float = 0.2,
) -> torch.Tensor:
    """``seed_row @ (A'_L @ ... @ A'_1)`` over lazily-normalized maps.

    With Â = F·[F >= t], s = rowsum(Â), λ = identity_weight:
    ``v @ A' == u @ Â + λ·u`` with ``u = v / (s + λ)``.

    Args:
      fused_maps: per-layer (B, N, N) raw maps (fp32 or bf16), forward order.
      thresholds / row_sums: per-layer ``masked_map_stats`` outputs.
      seed_row: (B, R, N) rows to propagate.

    Returns:
      (B, R, N) fp32.
    """
    v = seed_row.float()
    for f, t, s in reversed(list(zip(fused_maps, thresholds, row_sums))):
        u = v / (s + identity_weight)[:, None, :]
        ff = f.float()
        masked = torch.where(ff >= t.float()[:, None, None], ff, 0.0)
        v = (u[:, :, :, None] * masked[:, None, :, :]).sum(dim=2) + (
            identity_weight * u
        )
    return v


def normalize_attention_map(
    attn_fused: torch.Tensor,
    discard_ratio: float = 0.9,
    identity_weight: float = 0.2,
    exact_discard: bool = True,
    signed: bool = False,
) -> torch.Tensor:
    """Discard + identity-blend + row-normalize one (B, M, N) fused map.

    The lowest ``discard_ratio`` of the flattened M*N values are zeroed
    (every value below the keep-th largest, exact or, with
    ``exact_discard=False``, its 16-bit prefix floor), the identity is
    blended in at ``identity_weight`` (row-truncated when M < N) and each
    row divided by its sum. ``signed`` (mixed-sign maps) takes the exact
    threshold in the signed key space in either discard mode.
    Returns (B, M, N) fp32.
    """
    B, M, N = attn_fused.shape
    a = attn_fused.float()
    keep = M * N - int(M * N * discard_ratio)
    if keep < M * N:
        if signed:
            kth_fn = kth_largest_signed
        else:
            kth_fn = kth_largest if exact_discard else kth_largest_prefix16
        kth = kth_fn(a.reshape(B, M * N), keep)
        a = torch.where(a >= kth[:, None, None], a, 0.0)
    eye = torch.eye(N, dtype=torch.float32, device=a.device)[:M]
    a = (a + identity_weight * eye) / (1.0 + identity_weight)
    return a / a.sum(dim=-1, keepdim=True)


def rollout_step(
    result: torch.Tensor,
    attn: torch.Tensor,
    discard_ratio: float = 0.9,
    head_fusion: str = "mean",
    identity_weight: float = 0.2,
) -> torch.Tensor:
    """Fold one block's (B, H, N, N) probabilities into the (B, N, N)
    running product: ``normalize(fuse(attn)) @ result``."""
    a = normalize_attention_map(
        _fuse_heads(attn, head_fusion), discard_ratio, identity_weight
    )
    return torch.matmul(a, result)


def identity_rollout(batch: int, n: int, device=None) -> torch.Tensor:
    """Initial rollout carry: (batch, n, n) fp32 identities."""
    eye = torch.eye(n, dtype=torch.float32, device=device)
    return eye.expand(batch, n, n)


def rollout_row_scores(
    norm_maps: Sequence[torch.Tensor], seed_row: torch.Tensor
) -> torch.Tensor:
    """``seed_row @ (a_L @ ... @ a_1)`` as a chain of vector-matrix
    products over per-layer (B, N, N) normalized maps in forward order;
    seed_row (B, R, N). Returns (B, R, N) fp32."""
    v = seed_row.float()
    for a in reversed(list(norm_maps)):
        v = torch.matmul(v, a)
    return v


def attn_rollout(
    all_attn: torch.Tensor,
    discard_ratio: float = 0.9,
    head_fusion: str = "mean",
    identity_weight: float = 0.2,
) -> torch.Tensor:
    """Full rollout over a stacked (L, B, H, N, N) attention tensor (a
    Python loop in place of the JAX package's ``lax.scan``). Returns
    (B, N, N) fp32; the CLS->patch scores are ``out[:, 0, 1:]``."""
    L, B, H, N, _ = all_attn.shape
    result = identity_rollout(B, N, all_attn.device)
    for attn in all_attn:
        result = rollout_step(result, attn, discard_ratio, head_fusion,
                              identity_weight)
    return result


def attn_rollout_cait(
    sa_attn: torch.Tensor,
    ca_attn: torch.Tensor,
    discard_ratio: float = 0.9,
    head_fusion: str = "mean",
    identity_weight: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CaiT rollout, eagerly: the product of the normalized self-attention
    maps over the P patches, and the mean of the normalized class-attention
    rows (CLS column dropped) times that product.

    Args:
      sa_attn: (L_sa, B, H, P, P) self-attention maps.
      ca_attn: (L_ca, B, H, 1, 1+P) class-attention maps.

    Returns:
      (rollout (B, P, P), cls_scores (B, 1, P)), both fp32.
    """
    L_sa, B, H, P, _ = sa_attn.shape
    result = identity_rollout(B, P, sa_attn.device)
    for attn in sa_attn:
        result = rollout_step(result, attn, discard_ratio, head_fusion,
                              identity_weight)
    ca_norm = torch.stack([
        normalize_attention_map(_fuse_heads(attn, head_fusion), discard_ratio,
                                identity_weight)
        for attn in ca_attn
    ])
    cls_mean = ca_norm.mean(dim=0)[:, :, 1:]
    return result, torch.matmul(cls_mean, result)
