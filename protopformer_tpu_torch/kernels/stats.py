"""K2: fused lazy-rollout map statistics (port of
``protopformer_tpu/kernels/stats.py``).

``fused_map_stats`` returns the per-map discard threshold (the keep-th
largest value on the bit pattern, which the JAX kernel bisects for and the
port's kernels find by a radix select) and the masked row sums in one pass
over the map. A CUDA tensor goes to the hand-written kernel
(``csrc/map_stats.cu``); a CPU tensor goes to ``map_stats_plain``, the
plain PyTorch version of the same steps. Any other device raises.

``signed_map_stats_cuda`` runs the same kernel in the signed key space
(``ppf_signed_map_stats``) for maps that may hold negative values, CaiT's
talking-heads maps: ``ops.rollout.masked_map_stats(signed=True)`` takes it
on the card, and ``signed_map_stats_plain`` states its algorithm.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from protopformer_tpu_torch.kernels import _build
from protopformer_tpu_torch.utils.profiling import count, span


def bisect_keys(a: torch.Tensor, prefix16: bool) -> torch.Tensor:
    """(B, ...) fp32 values -> (B, E) int32 keys, those the JAX kernels
    bisect: the bit pattern, or its high 16 bits by a logical shift."""
    bits = a.contiguous().view(torch.int32).reshape(a.shape[0], -1)
    if prefix16:
        bits = (bits >> 16) & 0xFFFF
    return bits


def signed_keys(a: torch.Tensor, prefix16: bool) -> torch.Tensor:
    """(B, ...) fp32 values -> (B, E) int64 keys of the signed select
    (``csrc/common.cuh::select_key<true>``): each fp32 pattern u as the
    unsigned monotone key, u with its top bit set where the sign bit is
    clear and ~u where it is set, whose order is the values' order (-0.0
    just below +0.0); its high 16 bits in prefix16 mode, which of a bf16
    value are the key of its own 16-bit pattern."""
    u = bisect_keys(a, False).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u | (1 << 31))
    return key >> 16 if prefix16 else key


def threshold_from_signed_key(key: torch.Tensor, prefix16: bool
                              ) -> torch.Tensor:
    """(B,) ``signed_keys`` keys -> the fp32 values they are the keys of
    (``csrc/common.cuh::threshold_from_key<true>``)."""
    top = 1 << (15 if prefix16 else 31)
    key = key.to(torch.int64)
    bits = torch.where(key & top != 0, key & (top - 1), ~key & (2 * top - 1))
    if prefix16:
        bits = bits << 16
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def radix_select_keys(keys: torch.Tensor, keep: int, key_bits: int,
                      digit_bits: int, hi: int,
                      signed: bool = False) -> torch.Tensor:
    """Plain statement of the kernels' radix select (``csrc/common.cuh``,
    ``cluster_radix_select``, run by K1, K2 and K4/K5's normalize): per
    row of the (B, E) integer ``keys`` (``key_bits`` wide, as
    ``bisect_keys`` makes them), min(hi, the keep-th largest key), found
    digit by digit from the top, ``digit_bits`` bits a pass. A key whose
    top bit, the fp32 sign, is set (-0.0) counts as 0, as the JAX
    kernels' signed bisection never counts it. Each pass counts the keys
    that match the digits chosen so far by their next digit and takes the
    digit that holds the keep-th largest. This is what ``bisect_threshold``
    returns from [0, hi] on the same keys: both find the largest v <= hi
    with count(keys >= v) >= keep. ``signed``: the keys are
    ``signed_keys``', whose top bit marks a non-negative value, and none
    counts as 0. Returns (B,) in the keys' dtype."""
    k64 = keys.to(torch.int64) & ((1 << key_bits) - 1)
    if not signed:
        k64 = torch.where(k64 >> (key_bits - 1) == 1, 0, k64)
    B = k64.shape[0]
    radix = 1 << digit_bits
    dev = keys.device
    prefix = torch.zeros(B, dtype=torch.int64, device=dev)
    k = torch.full((B,), keep, dtype=torch.int64, device=dev)
    for shift in range(key_bits - digit_bits, -1, -digit_bits):
        match = (k64 >> (shift + digit_bits)) == prefix[:, None]
        digit = (k64 >> shift) & (radix - 1)
        hist = torch.zeros((B, radix + 1), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, digit, match.to(torch.int64))
        # at_or_above[:, d]: matching keys whose digit is d or larger
        at_or_above = hist.flip(1).cumsum(1).flip(1)
        d = (at_or_above[:, :radix] >= k[:, None]).sum(1) - 1
        k = k - at_or_above.gather(1, (d + 1)[:, None])[:, 0]
        prefix = (prefix << digit_bits) | d
    return prefix.clamp(max=hi).to(keys.dtype)


def threshold_from_key(lo: torch.Tensor, prefix16: bool) -> torch.Tensor:
    return (lo << 16 if prefix16 else lo).view(torch.float32)


def masked_row_sums(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, N, N) fp32 map, (B,) fp32 threshold -> (B, N) fp32."""
    return torch.where(a >= t[:, None, None], a, 0.0).sum(dim=-1)


def map_stats_plain(fmap: torch.Tensor, keep: int, prefix16: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the radix select of the
    keep-th largest key over the whole key space (the JAX kernel's
    bisection from [0, max]), then the masked row sums. Returns
    (t (B,) fp32, s (B, N) fp32)."""
    a = fmap.float()
    bits = 16 if prefix16 else 32
    lo = radix_select_keys(bisect_keys(a, prefix16), keep, bits, 8,
                           (1 << bits) - 1)
    t = threshold_from_key(lo, prefix16)
    return t, masked_row_sums(a, t)


def signed_map_stats_plain(fmap: torch.Tensor, keep: int, prefix16: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the signed kernel (``ppf_signed_map_stats``)
    on a (B, N, N) map: the radix select of the keep-th largest of
    ``signed_keys`` (16 bits of a bf16 map's in prefix16 mode, else 32),
    its value by ``threshold_from_signed_key``, then the masked row sums.
    The same t as the bisections ``ops.rollout.kth_largest_bf16_signed``
    and ``kth_largest_signed``: each finds the keep-th largest key of one
    order of the values. Returns (t (B,) fp32, s (B, N) fp32)."""
    a = fmap.float()
    bits = 16 if prefix16 else 32
    key = radix_select_keys(signed_keys(a, prefix16), keep, bits, 8,
                            (1 << bits) - 1, signed=True)
    t = threshold_from_signed_key(key, prefix16)
    return t, masked_row_sums(a, t)


# The select's routes (``csrc/common.cuh::map_route``), as
# ``ppf_map_stats_route`` and ``ppf_attention_core_route`` number them:
# one step up to 256 columns; each CTA's band in shared memory as fp32 (up
# to 640 columns, and past 640 K4/K5's normalize where its rows straddle
# 128-byte lines and the band fits); the band read in place from the map
# (past 640 columns).
SELECT_ROUTES = {"one_step": 0, "band": 1, "in_place": 2}


def check_map(fmap: torch.Tensor) -> Tuple[int, int]:
    """The checks of ``map_stats_cuda`` on a map: a contiguous (B, N, N)
    fp32 or bf16 map of any N (up to 640 tokens each CTA of a sample's
    cluster holds its band in shared memory; above, it reads the band where
    the map lies, ``SELECT_ROUTES``). Returns (B, N)."""
    if fmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"map_stats: map dtype {fmap.dtype} not fp32/bf16")
    if fmap.dim() != 3 or fmap.shape[1] != fmap.shape[2]:
        raise ValueError(f"map_stats: expected (B, N, N), got {tuple(fmap.shape)}")
    if not fmap.is_contiguous():
        raise ValueError("map_stats: map must be contiguous")
    return fmap.shape[0], fmap.shape[1]


def map_stats_cuda(fmap: torch.Tensor, keep: int, prefix16: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/map_stats.cu`` on a contiguous (B, N, N) CUDA map."""
    B, N = check_map(fmap)
    lib = _build.library()
    t = torch.empty(B, dtype=torch.float32, device=fmap.device)
    s = torch.empty((B, N), dtype=torch.float32, device=fmap.device)
    with _build.on_device(fmap.device) as stream:
        code = lib.ppf_map_stats(
            fmap.data_ptr(), int(fmap.dtype == torch.bfloat16), B, N, keep,
            int(prefix16), t.data_ptr(), s.data_ptr(), stream,
        )
    _build.check_launch("map_stats", code)
    count("launches.fused_map_stats")
    return t, s


def signed_map_stats_cuda(fmap: torch.Tensor, keep: int, prefix16: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/map_stats.cu``'s signed select on a contiguous (B, N,
    N) CUDA map of fp32 or bf16 (``check_map``), on the route the shape
    picks; ``prefix16`` (a bf16 map's 16-bit keys) takes only a bf16 map.
    Counts ``launches.signed_map_stats``. Returns (t (B,) fp32, s (B, N)
    fp32)."""
    B, N = check_map(fmap)
    if prefix16 and fmap.dtype != torch.bfloat16:
        raise ValueError("signed_map_stats: 16-bit keys are a bf16 map's; "
                         "an fp32 map takes 32-bit keys")
    if not fmap.is_cuda:
        raise ValueError(f"signed_map_stats: expected a CUDA tensor, got "
                         f"{fmap.device}")
    lib = _build.library()
    t = torch.empty(B, dtype=torch.float32, device=fmap.device)
    s = torch.empty((B, N), dtype=torch.float32, device=fmap.device)
    with _build.on_device(fmap.device) as stream:
        code = lib.ppf_signed_map_stats(
            fmap.data_ptr(), int(fmap.dtype == torch.bfloat16), B, N, keep,
            int(prefix16), t.data_ptr(), s.data_ptr(), stream,
        )
    _build.check_launch("signed_map_stats", code)
    count("launches.signed_map_stats")
    return t, s


def select_route(tokens: int, launches: str = "map_stats",
                 reset: bool = True) -> Dict[str, int]:
    """The route record of the cluster select above 256 tokens since its
    last reset, for K2's launches (``"map_stats"``: K2 and K1's select) or
    K4/K5's normalize (``"core"``), read against the caps of maps of
    ``tokens`` rows: ``lists`` is the largest total of a sample's compact
    key lists against ``lists_cap``, ``cta_list`` the
    largest CTA list against ``cta_cap``, and ``band_passes`` the samples
    whose lists overflowed, which ran the last two passes over their
    bands. Waits for the card's work first."""
    lib = _build.library()
    torch.cuda.synchronize()
    fn = {"map_stats": lib.ppf_map_stats_select_route,
          "core": lib.ppf_attention_core_select_route}[launches]
    out = (ctypes.c_int * 3)()
    _build.check_launch(f"{launches} select_route",
                        fn(ctypes.addressof(out), int(reset)))
    return {"lists": out[0], "lists_cap": 7168 if tokens > 512 else 3072,
            "cta_list": out[1], "cta_cap": 1024, "band_passes": out[2]}


def fused_map_stats(
    fmap: torch.Tensor,
    discard_ratio: float = 0.9,
    exact_discard: bool = False,
    keep_elements: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold + masked row sums of a square (B, N, N) non-negative map.

    Same contract as the JAX ``fused_map_stats``: ``keep_elements`` is the
    real element count of a zero-padded map; with no discard the threshold
    is a -inf sentinel and no kernel launches.

    Returns:
      (t (B,) in the map dtype, s (B, N) fp32).
    """
    B, M, N = fmap.shape
    if M != N:
        raise ValueError("fused_map_stats is for square self-attention maps")
    real = keep_elements if keep_elements is not None else M * N
    keep = real - int(real * discard_ratio)
    if keep >= real:
        return (
            torch.full((B,), float("-inf"), dtype=torch.float32,
                       device=fmap.device),
            fmap.float().sum(dim=-1),
        )
    prefix16 = not exact_discard
    with span("fused_map_stats", fmap):
        if fmap.is_cuda:
            t, s = map_stats_cuda(fmap, keep, prefix16)
        elif fmap.device.type == "cpu":
            t, s = map_stats_plain(fmap, keep, prefix16)
        else:
            raise RuntimeError(
                f"fused_map_stats: no kernel for device {fmap.device}")
    return t.to(fmap.dtype), s
