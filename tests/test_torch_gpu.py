"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips it where no CUDA device exists. The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed; on such a
machine run it without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: thresholds t bit-equal, row sums 1e-6, fp32 outputs 1e-5 and
maps 1e-6 (those of the JAX package's kernel tests); K3's bf16 output 1e-2;
a micro train step on the card against the CPU in fp32, and two gloo ranks
sharing the card against the one-process card step: the loss within
1e-5, gradients within 2e-4 * max|g| + 1e-7, the AdamW step within 1e-6
of the reference's step on the card's gradients; the mesh engine against
one device in fp32: logits 1e-5, the same top-81; int8 serving against
the CPU's int8 forward: serving's bf16 selection contract.
K1 sums the dots of QK^T on tensor cores, in another order than the plain
version's fp32 matmul, and rounds each logit to bf16 at once: a logit can
then land one bf16 ulp away and move its row of the map, so the map is not
bit-equal to the plain version's, and t, an order statistic of the map,
may differ from the plain t as well. K1 is held as chip_smoke.py holds it:
t bit-equal to masked_map_stats on the kernel's own map and s within 1e-6
of that map's masked row sums; against the plain version the map within
one bf16 ulp of its largest entry, out within 2 bf16 ulps of max|out|, at
most 1e-4 of the map's entries per 3 heads (or one row) differing, and t
differing in
at most max(1, B // 80) samples, each one whose map differs. K4/K5
emit a map normalized after a k-th largest discard, where a one-ulp
difference in the raw map can move an entry across the threshold: each is
held against the plain normalize of K3's raw map on the same inputs (the
same device code, so the same raw map: identical kept entries, map within
1e-6), and against its plain version (out as above; map within 1e-6 on
every sample whose kept entries agree).
"""

import math
import subprocess

import numpy as np
import pytest
import torch

from protopformer_tpu_torch import kernels
from protopformer_tpu_torch.kernels import attention_core as ac
from protopformer_tpu_torch.kernels import stats
from protopformer_tpu_torch.ops.rollout import (
    masked_map_stats,
    normalize_attention_map,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(1028)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _bf16_ulp(x):
    """The bf16 ulp (2^-7 of the power of two below) at max|x|."""
    return math.ldexp(1.0, math.frexp(float(x.float().abs().max()))[1] - 8)


def _prob_maps(rng, B, N):
    maps = rng.uniform(size=(B, N, N)).astype(np.float32)
    return torch.from_numpy(maps / maps.sum(-1, keepdims=True))


def _qkv_policy(rng, B, N, NP, C):
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    pol = (rng.uniform(size=(B, N)) > 0.4).astype(np.float32)
    pol[:, 0] = 1.0
    qkv = np.pad(qkv, ((0, 0), (0, NP - N), (0, 0)))
    return torch.from_numpy(qkv), torch.from_numpy(np.pad(pol, ((0, 0), (0, NP - N))))


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("exact", [True, False])
# N=40 runs the kernel built for 4 key tiles on 3 tiles of tokens
# DeiT-Tiny, -Small and -Base at 224: 3, 6 and 12 heads (head dims 64);
# the long path (the heads kernel in CTAs of 3 row tiles, then K2's select)
# at deit_tiny_patch2_32's 257 tokens, 301 (a ragged last chunk and band),
# DeiT-B/16@384's 577 at 3 and 12 heads, and the limit, 640
@pytest.mark.parametrize("N,C,H", [(197, 192, 3), (24, 16, 2), (40, 64, 2),
                                   (197, 384, 6), (197, 768, 12),
                                   (257, 192, 3), (301, 192, 3),
                                   (577, 192, 3), (577, 768, 12),
                                   (640, 192, 3)])
def test_block_stats_kernel_matches_plain(rng, cuda, exact, N, C, H, B):
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16)
    before = kernels.launch_counts()["fused_attention_block_stats"]
    out, fmap, t, s = ac.fused_attention_block_stats(qkv, H, 0.9, exact)
    assert kernels.launch_counts()["fused_attention_block_stats"] == before + 1
    p_out, p_map, p_t, _ = ac.block_stats_plain(
        qkv, H, N * N - int(N * N * 0.9), exact
    )
    own_t, _ = masked_map_stats(fmap, 0.9, exact_discard=exact)
    torch.cuda.synchronize()
    assert fmap.dtype == (torch.float32 if exact else torch.bfloat16)
    assert torch.equal(t, own_t)
    assert _max_err(s, stats.masked_row_sums(fmap.float(), t.float())) <= 1e-6
    assert _max_err(fmap, p_map) <= _bf16_ulp(p_map)
    assert _max_err(out, p_out) <= 2 * _bf16_ulp(p_out)
    map_diff = (fmap != p_map).flatten(1)
    # the count grows with the H * B * N^2 logits that can round the other
    # way: 1e-4 of the map's entries per 3 heads (chip_smoke.k1_contract)
    assert int(map_diff.sum()) <= max(int(1e-4 * fmap.numel() * max(H, 3)
                                          / 3), N)
    t_diff = t != p_t.to(t.dtype)
    assert int(t_diff.sum()) <= max(1, B // 80)
    assert bool((map_diff.any(dim=1) | ~t_diff).all())


@pytest.mark.parametrize("exact", [True, False])
def test_block_stats_long_select_caps_the_threshold_at_one(rng, cuda, exact):
    """Above 256 tokens K1's threshold comes from K2's select capped at the
    key of 1.0, as the JAX kernel's bisection from [0, 1] is: at 10 heads
    the fp32 head mean of ten probabilities of 1 is 1.0000001, and with
    keep = 1 the cap binds in exact mode."""
    B, N, C, H = 2, 257, 320, 10
    hd = C // H
    qkv = (0.05 * rng.normal(size=(B, N, 3 * C))).astype(np.float32)
    # token 5 attends to token 9 alone in every head
    qkv[:, 5, 0:C:hd] = 20.0
    qkv[:, 9, C:2 * C:hd] = 20.0
    qkv = torch.from_numpy(qkv).to(cuda, torch.bfloat16)
    E = N * N
    ratio = 1.0 - 0.5 / E  # keep = E - int(E * ratio) = 1
    out, fmap, t, s = ac.fused_attention_block_stats(qkv, H, ratio, exact)
    p_out, p_map, p_t, _ = ac.block_stats_plain(qkv, H, 1, exact)
    torch.cuda.synchronize()
    assert float(fmap[:, 5, 9].float().min()) >= 1.0
    if exact:
        assert float(fmap.max()) > 1.0  # the cap binds
    assert torch.equal(t.float(), torch.ones_like(t, dtype=torch.float32))
    assert torch.equal(t, p_t.to(t.dtype))
    assert _max_err(s, stats.masked_row_sums(fmap.float(), t.float())) <= 1e-6
    assert _max_err(fmap, p_map) <= _bf16_ulp(p_map)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("exact", [True, False])
# one CTA a sample at 17 and 24 tokens, a cluster of 2 at 82 and 4 at 197
# (bands of 49-50 rows) and 256 (64 rows), 5 at 257 (51-52 rows), and 16
# at 577 (36-37 rows) and 640 (40 rows)
@pytest.mark.parametrize("N", [17, 24, 82, 197, 256, 257, 577, 640])
def test_map_stats_kernel_matches_plain(rng, cuda, exact, N, B):
    maps = _prob_maps(rng, B, N).to(cuda)
    if not exact:
        maps = maps.bfloat16()
    before = kernels.launch_counts()["fused_map_stats"]
    t, s = stats.fused_map_stats(maps, 0.9, exact_discard=exact)
    assert kernels.launch_counts()["fused_map_stats"] == before + 1
    want_t, want_s = stats.fused_map_stats(maps.cpu(), 0.9, exact_discard=exact)
    assert torch.equal(t.cpu(), want_t)
    assert _max_err(s.cpu(), want_s) <= 1e-6


@pytest.mark.parametrize("exact,dtype", [(True, torch.float32),
                                         (False, torch.float32),
                                         (False, torch.bfloat16)])
def test_map_stats_kernel_negative_zero(rng, cuda, exact, dtype):
    """-0.0 entries count as zeros in the select, as in the plain version:
    a row of them in every map, and all but keep - 3 entries of map 2."""
    B, N = 3, 197
    maps = _prob_maps(rng, B, N)
    keep = N * N - int(N * N * 0.9)
    maps[:, 5, :] = -0.0
    maps[2].view(-1)[keep - 3:] = -0.0
    maps = maps.to(dtype)
    t, s = stats.fused_map_stats(maps.to(cuda), 0.9, exact_discard=exact)
    want_t, want_s = stats.fused_map_stats(maps, 0.9, exact_discard=exact)
    assert torch.equal(t.cpu().float().view(torch.int32),
                       want_t.float().view(torch.int32))
    assert float(want_t[2]) == 0.0
    assert _max_err(s.cpu(), want_s) <= 1e-6


@pytest.mark.parametrize("C,H", [(192, 3), (384, 6), (768, 12)])
def test_map_stats_kernel_on_a_speed_mode_map(rng, cuda, C, H):
    """K2's speed mode (a bf16 map, the 16-bit prefix select) on the bf16
    head-mean map that K1 stores in speed mode, at B=8, N=197: t
    bit-equal to ``map_stats_plain(prefix16=True)``, s within 1e-6."""
    N = 197
    qkv = torch.from_numpy(rng.normal(size=(8, N, 3 * C)).astype(np.float32))
    _, fmap, _, _ = ac.fused_attention_block_stats(
        qkv.to(cuda, torch.bfloat16), H, 0.9, False)
    assert fmap.dtype == torch.bfloat16
    before = kernels.launch_counts()["fused_map_stats"]
    t, s = stats.fused_map_stats(fmap, 0.9, exact_discard=False)
    assert kernels.launch_counts()["fused_map_stats"] == before + 1
    want_t, want_s = stats.map_stats_plain(fmap, N * N - int(N * N * 0.9),
                                           prefix16=True)
    torch.cuda.synchronize()
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.float(), want_t)
    assert _max_err(s, want_s) <= 1e-6


def test_map_stats_kernel_padded_keep_elements(rng, cuda):
    B, NR, NP = 8, 17, 24
    maps = torch.zeros((B, NP, NP))
    maps[:, :NR, :NR] = torch.from_numpy(
        rng.uniform(size=(B, NR, NR)).astype(np.float32)
    )
    t, s = stats.fused_map_stats(maps.to(cuda), 0.9, True, keep_elements=NR * NR)
    want_t, want_s = stats.fused_map_stats(maps, 0.9, True, keep_elements=NR * NR)
    assert torch.equal(t.cpu(), want_t)
    assert _max_err(s.cpu(), want_s) <= 1e-6


@pytest.mark.parametrize("dtype,N,NP,C,H", [
    (torch.float32, 197, 197, 192, 3),
    (torch.float32, 17, 24, 24, 2),
    (torch.bfloat16, 82, 82, 192, 3),
    (torch.bfloat16, 197, 256, 192, 3),
    # the kernel built for 4 key tiles on 3 tiles of tokens
    (torch.bfloat16, 35, 40, 64, 2),
    # DeiT-Small and -Base: every block in fp32, block 11 gathered in bf16
    (torch.float32, 197, 197, 384, 6),
    (torch.float32, 197, 197, 768, 12),
    (torch.bfloat16, 82, 82, 384, 6),
    (torch.bfloat16, 82, 82, 768, 12),
    # the long kernels: deit_tiny_patch2_32 (257), DeiT-B/16@384 (577, and
    # 640 as the JAX package pads it), bf16 after a gather of 300 tokens;
    # fp32 at 301 (a ragged last chunk of 45 keys) and 577 at 3 and 12 heads
    (torch.float32, 257, 257, 192, 3),
    (torch.float32, 301, 301, 192, 3),
    (torch.float32, 577, 577, 192, 3),
    (torch.float32, 577, 577, 768, 12),
    (torch.float32, 577, 640, 192, 3),
    (torch.float32, 577, 640, 768, 12),
    (torch.bfloat16, 257, 257, 192, 3),
    (torch.bfloat16, 301, 301, 192, 3),
    (torch.bfloat16, 577, 640, 768, 12),
])
def test_mean_padded_kernel_matches_plain(rng, cuda, dtype, N, NP, C, H):
    qkv, pol = _qkv_policy(rng, 8, N, NP, C)
    qkv, pol = qkv.to(cuda, dtype), pol.to(cuda)
    out, fmap = ac.fused_attention_mean_padded(qkv, pol, H, real_n=N)
    p_out, p_map = ac.mean_padded_plain(qkv, pol, H, real_n=N)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _max_err(out[:, :N], p_out[:, :N]) <= tol
    assert _max_err(fmap, p_map) <= 1e-6
    assert float(fmap[:, N:].abs().sum()) == 0.0
    assert float(fmap[:, :, N:].abs().sum()) == 0.0


def _kept(norm_map):
    """Entries the discard kept: off-diagonal and > 0 after the normalize
    (the identity blend makes every real diagonal entry > 0)."""
    eye = torch.eye(norm_map.shape[-1], dtype=torch.bool,
                    device=norm_map.device)
    return (norm_map > 0) & ~eye


def _check_core(qkv, pol, H, real_n, out, fmap, p_out, p_map):
    """The two holds of a K4/K5 launch (module docstring)."""
    N = real_n
    _, raw = ac.fused_attention_mean_padded(qkv, pol, H, real_n)
    want = normalize_attention_map(raw[:, :N, :N], 0.9, 0.2, True)
    torch.cuda.synchronize()
    assert torch.equal(_kept(fmap[:, :N, :N]), _kept(want))
    assert _max_err(fmap[:, :N, :N], want) <= 1e-6
    assert float(fmap[:, N:].abs().sum()) == 0.0
    assert float(fmap[:, :, N:].abs().sum()) == 0.0
    if qkv.dtype == torch.float32:
        assert _max_err(out[:, :N], p_out[:, :N]) <= 1e-5
    else:
        tol = 2.0 ** -8 * float(p_out.float().abs().max())
        assert _max_err(out[:, :N], p_out[:, :N]) <= tol
    agree = (_kept(fmap) == _kept(p_map)).flatten(1).all(dim=1)
    assert bool(agree.any())
    assert _max_err(fmap[agree], p_map[agree]) <= 1e-6


@pytest.mark.parametrize("dtype,N,C,H,ones", [
    (torch.bfloat16, 197, 192, 3, True),
    (torch.float32, 197, 192, 3, False),
    (torch.float32, 24, 16, 2, True),
    (torch.bfloat16, 256, 192, 3, True),
    (torch.float32, 256, 192, 3, False),
    # masked_forward_thresh at 384 (K4 on DeiT-B's 577 tokens) and at 257
    (torch.bfloat16, 577, 768, 12, True),
    (torch.float32, 577, 768, 12, False),
    (torch.float32, 257, 192, 3, False),
])
def test_core_kernel_matches_plain(rng, cuda, dtype, N, C, H, ones):
    qkv, pol = _qkv_policy(rng, 8, N, N, C)
    qkv, pol = qkv.to(cuda, dtype), pol.to(cuda)
    before = kernels.launch_counts()["fused_attention_core"]
    out, fmap = ac.fused_attention_core(qkv, pol, H, ones_policy=ones)
    assert kernels.launch_counts()["fused_attention_core"] == before + 1
    if ones:
        pol = torch.ones_like(pol)
    p_out, p_map = ac.core_plain(qkv, pol, H)
    _check_core(qkv, pol, H, N, out, fmap, p_out, p_map)


@pytest.mark.parametrize("dtype,N,NP,C,H", [
    (torch.bfloat16, 197, 256, 192, 3),
    (torch.float32, 17, 32, 24, 2),
    # the normalize over a cluster takes every real_n <= 256
    (torch.bfloat16, 250, 256, 192, 3),
    (torch.bfloat16, 256, 256, 192, 3),
    (torch.float32, 250, 256, 192, 3),
    # real 577 in NP 640, as the JAX package pads the 384 presets
    (torch.bfloat16, 577, 640, 192, 3),
    (torch.float32, 577, 640, 768, 12),
])
def test_core_padded_kernel_matches_plain(rng, cuda, dtype, N, NP, C, H):
    qkv, pol = _qkv_policy(rng, 8, N, NP, C)
    qkv, pol = qkv.to(cuda, dtype), pol.to(cuda)
    before = kernels.launch_counts()["fused_attention_core_padded"]
    out, fmap = ac.fused_attention_core_padded(qkv, pol, H, N)
    assert kernels.launch_counts()["fused_attention_core_padded"] == before + 1
    p_out, p_map = ac.core_padded_plain(qkv, pol, H, N)
    _check_core(qkv, pol, H, N, out, fmap, p_out, p_map)


# --- the long bf16 attention (bf16k::mean_long_kernel) -----------------------

def _mean_bf16_null_policy(qkv, H, real_n):
    """K3's bf16 launch with a null policy (K4's ones_policy), straight
    through the library: (out, map)."""
    from protopformer_tpu_torch.kernels import _build

    B, NP, C3 = qkv.shape
    C = C3 // 3
    out = torch.empty((B, NP, C), dtype=qkv.dtype, device=qkv.device)
    fmap = torch.empty((B, NP, NP), dtype=torch.float32, device=qkv.device)
    # the bf16 kernels need no scratch at any NP
    code = _build.library().ppf_attention_mean(
        qkv.data_ptr(), None, B, NP, C, H, real_n, 1, (C // H) ** -0.5,
        1e-6 / real_n, out.data_ptr(), fmap.data_ptr(),
        torch.cuda.current_stream(qkv.device).cuda_stream, None)
    _build.check_launch("attention_mean", code)
    return out, fmap


@pytest.mark.parametrize("N,NP,C,H,policy", [
    # deit_tiny_patch2_32 (257: a last block of 17 rows), a ragged last
    # chunk (301), DeiT-B/16@384's 577 (a last block of one row) at 3 and 12
    # heads, real 577 in NP 640 (K5's bench operands) and the limit, 640;
    # each with the policy of zeros and the null one (K4's ones policy)
    (257, 257, 192, 3, "zeros"),
    (257, 257, 768, 12, "null"),
    (301, 301, 768, 12, "null"),
    (301, 301, 192, 3, "zeros"),
    (577, 577, 192, 3, "null"),
    (577, 577, 768, 12, "zeros"),
    (577, 577, 768, 12, "null"),
    (577, 640, 768, 12, "zeros"),
    (577, 640, 192, 3, "null"),
    (640, 640, 192, 3, "zeros"),
    (640, 640, 768, 12, "null"),
    # past 640: the global route (the head mean in the map) in 3 row tiles
    # at 785 (DeiT-Tiny/16 at 448) and 896 (K5's bench pad of it), in 1
    # at 1,025 (512 px) and 1,601
    (785, 785, 192, 3, "null"),
    (785, 896, 192, 3, "zeros"),
    (1025, 1025, 192, 3, "null"),
    (1025, 1152, 768, 12, "zeros"),
    (1601, 1601, 192, 3, "zeros"),
])
def test_mean_long_bf16_kernel_matches_plain(rng, cuda, N, NP, C, H, policy):
    """The long bf16 attention against ``mean_padded_plain``: out within
    1e-2, the map within 1e-6 and 0 outside the real block. Row 5's query
    is zero in every head, so all of its logits are equal."""
    qkv, pol = _qkv_policy(rng, 3, N, NP, C)
    qkv[:, 5, :C] = 0.0
    qkv = qkv.to(cuda, torch.bfloat16)
    pol = pol.to(cuda)
    if policy == "null":
        pol = torch.ones_like(pol)
        pol[:, N:] = 0.0
        out, fmap = _mean_bf16_null_policy(qkv, H, N)
        # the null policy is all ones, the pads' columns included
        p_out, p_map = ac.mean_padded_plain(qkv, torch.ones_like(pol), H, N)
    else:
        out, fmap = ac.fused_attention_mean_padded(qkv, pol, H, real_n=N)
        p_out, p_map = ac.mean_padded_plain(qkv, pol, H, N)
    torch.cuda.synchronize()
    assert _max_err(out[:, :N], p_out[:, :N]) <= 1e-2
    assert _max_err(fmap, p_map) <= 1e-6
    assert float(fmap[:, N:].abs().sum()) == 0.0
    assert float(fmap[:, :, N:].abs().sum()) == 0.0
    # the equal logits of row 5: the row's map entries equal where the
    # policy is (1 off the diagonal in every head)
    row = fmap[:, 5, :N]
    keep = pol[:, :N] > 0
    keep[:, 5] = False
    for b in range(row.shape[0]):
        vals = row[b][keep[b]]
        assert float(vals.max() - vals.min()) <= 1e-7


# --- the map select above 256 tokens -------------------------------------------

_CLUSTER_SIZES = [(17, 1), (100, 2), (150, 3), (197, 4), (257, 5), (350, 6),
                  (400, 7), (449, 8), (512, 8), (513, 16), (577, 16),
                  (640, 16)]


@pytest.mark.parametrize("N,cs", _CLUSTER_SIZES)
def test_map_stats_takes_every_cluster_size(rng, cuda, N, cs):
    """Each cluster size the band sizing picks (``map_cluster_size``: 1-8
    CTAs of at most 64 rows up to 512 rows, 16 above), with its clusters
    resident on the card: t bit-equal to the plain version, s within
    1e-6, in both key widths."""
    from protopformer_tpu_torch.kernels import _build

    lib = _build.library()
    assert lib.ppf_map_stats_cluster_size(N) == cs
    assert lib.ppf_attention_core_cluster_size(N) == cs
    for bf16 in (0, 1):
        assert lib.ppf_map_stats_active_clusters(N, bf16) > 0
    assert lib.ppf_attention_core_active_clusters(N, N) > 0
    maps = _prob_maps(rng, 3, N).to(cuda)
    for exact, m in ((True, maps), (False, maps.bfloat16())):
        t, s = stats.fused_map_stats(m, 0.9, exact_discard=exact)
        want_t, want_s = stats.fused_map_stats(m.cpu(), 0.9,
                                               exact_discard=exact)
        assert torch.equal(t.cpu(), want_t)
        assert _max_err(s.cpu(), want_s) <= 1e-6


def _select_maps(rng, B, N, kind):
    """(B, N, N) fp32 maps for the select: probabilities with a row and a
    run of -0.0 ("signed zeros"), or maps on which the compact lists at
    the top 16 bits overflow: values within 1 % of 1/N ("narrow"), every
    key tied ("flat") or 5 distinct values ("few")."""
    if kind == "flat":
        return torch.full((B, N, N), 1.0 / N)
    if kind == "narrow":
        return torch.from_numpy(
            (1.0 + 0.01 * rng.uniform(size=(B, N, N))).astype(np.float32) / N)
    if kind == "few":
        return torch.from_numpy(
            rng.integers(1, 6, size=(B, N, N)).astype(np.float32) / N)
    maps = _prob_maps(rng, B, N)
    maps[:, 7, :] = -0.0
    maps.view(B, -1)[:, 3 * N:3 * N + N * N // 3] = -0.0
    return maps


@pytest.mark.parametrize("N", [449, 512, 513, 577, 640, 785, 1025])
@pytest.mark.parametrize("kind", ["signed zeros", "narrow", "flat", "few"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_map_select_long_matches_plain(rng, cuda, N, kind, dtype):
    """The select above 256 tokens (bands of 57-64 rows in clusters of 8
    up to 512 rows, of 33-40 in clusters of 16 above; the last two passes
    over the compact key list, or over the band where the list
    overflows) against ``map_stats_plain`` at keep = 1, 10 % of the
    entries, and every entry: t bit-equal (its sign bit too) in both key
    widths, s within 1e-6. Where every key shares its top 16 bits with a
    fifth of the map or more ("flat", "few"), the lists overflow at every
    keep and the route record shows each sample on the band passes."""
    maps = _select_maps(rng, 3, N, kind).to(dtype)
    on_card = maps.to(cuda)
    for keep in (1, N * N - int(N * N * 0.9), N * N):
        for prefix16 in (False, True):
            stats.select_route(N)  # zeroes the route record
            t, s = stats.map_stats_cuda(on_card, keep, prefix16)
            want_t, want_s = stats.map_stats_plain(maps, keep, prefix16)
            route = stats.select_route(N)
            assert torch.equal(t.cpu().view(torch.int32),
                               want_t.view(torch.int32))
            assert _max_err(s.cpu(), want_s) <= 1e-6
            if kind in ("flat", "few"):
                assert route["band_passes"] == (0 if prefix16 else 3)
            if kind == "flat" and not prefix16:
                assert torch.equal(want_t, maps.float()[:, 0, 0])


@pytest.mark.parametrize("N", [513, 577, 640])
@pytest.mark.parametrize("exact", [True, False])
def test_block_stats_select_caps_the_threshold_at_one_in_16_ctas(rng, cuda,
                                                                 N, exact):
    """K1's select above 512 tokens (a cluster of 16) capped at the key of
    1.0, as ``test_block_stats_long_select_caps_the_threshold_at_one``
    holds it at 257."""
    B, C, H = 2, 320, 10
    hd = C // H
    qkv = (0.05 * rng.normal(size=(B, N, 3 * C))).astype(np.float32)
    qkv[:, 5, 0:C:hd] = 20.0
    qkv[:, 9, C:2 * C:hd] = 20.0
    qkv = torch.from_numpy(qkv).to(cuda, torch.bfloat16)
    E = N * N
    ratio = 1.0 - 0.5 / E  # keep = 1
    out, fmap, t, s = ac.fused_attention_block_stats(qkv, H, ratio, exact)
    _, p_map, p_t, _ = ac.block_stats_plain(qkv, H, 1, exact)
    torch.cuda.synchronize()
    assert float(fmap[:, 5, 9].float().min()) >= 1.0
    if exact:
        assert float(fmap.max()) > 1.0  # the cap binds
    assert torch.equal(t.float(), torch.ones_like(t, dtype=torch.float32))
    assert torch.equal(t, p_t.to(t.dtype))
    assert _max_err(s, stats.masked_row_sums(fmap.float(), t.float())) <= 1e-6
    assert _max_err(fmap, p_map) <= _bf16_ulp(p_map)


@pytest.mark.parametrize("dtype,N,NP,C,H", [
    (torch.bfloat16, 449, 449, 192, 3),
    (torch.bfloat16, 513, 513, 192, 3),
    (torch.float32, 513, 513, 192, 3),
    (torch.bfloat16, 640, 640, 192, 3),
    (torch.bfloat16, 577, 640, 768, 12),
])
def test_core_normalize_above_512_rows_matches_plain(rng, cuda, dtype, N, NP,
                                                     C, H):
    """K4/K5 whose normalize takes a cluster of 8 (449) or 16 (513 and
    up), held as ``test_core_padded_kernel_matches_plain`` holds K5."""
    qkv, pol = _qkv_policy(rng, 4, N, NP, C)
    qkv, pol = qkv.to(cuda, dtype), pol.to(cuda)
    out, fmap = ac.fused_attention_core_padded(qkv, pol, H, N)
    p_out, p_map = ac.core_padded_plain(qkv, pol, H, N)
    _check_core(qkv, pol, H, N, out, fmap, p_out, p_map)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        ac.fused_attention_block_stats(
            torch.zeros((2, 24, 48), device=cuda), 2, 0.9
        )
    with pytest.raises(ValueError):
        ac.fused_attention_mean_padded(
            torch.zeros((2, 24, 48), device=cuda).transpose(1, 2), torch.ones(
                (2, 48), device=cuda), 2, 48,
        )
    # no fixed token count: 641 launches everywhere; what limits N is a
    # block's shared memory, and a wrapper names it (K1's heads kernel
    # holds 16 rows of bf16 logits, K3's bf16 long kernel 16 of fp32)
    t, _ = stats.fused_map_stats(torch.zeros((2, 641, 641), device=cuda), 0.9)
    out, _ = ac.fused_attention_core(torch.zeros((2, 641, 48), device=cuda),
                                     None, 2, ones_policy=True)
    torch.cuda.synchronize()
    assert t.shape == (2,) and out.shape == (2, 641, 16)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ac.fused_attention_block_stats(
            torch.zeros((1, 8000, 48), device=cuda, dtype=torch.bfloat16), 2,
            0.9)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ac.fused_attention_mean_padded(
            torch.zeros((1, 4000, 48), device=cuda, dtype=torch.bfloat16),
            torch.ones((1, 4000), device=cuda), 2, 3000)


# --- past 640 tokens: every kernel's route above its old limit ---------------

# 641 (one past the old limit), DeiT-Tiny/16 at 448 px (785) and 512 px
# (1,025), 901 (past the map select's shared-memory band), 1,601
_PAST_640 = [641, 785, 901, 1025, 1601]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("N", _PAST_640 + [2305])
def test_block_stats_past_640_matches_plain(rng, cuda, exact, N):
    """K1 past 640 tokens, held as ``test_block_stats_kernel_matches_plain``
    holds it (B=3, B=2 at 2,305): the heads kernel's accumulator in
    device memory, in 3 row tiles up to ~2,000 tokens and in 1 above, its
    passes 2 and 3 looping over a row's steps; K2's select on the stored
    map in shared memory up to ~850 tokens, read in place above."""
    B, C, H = (2 if N > 1601 else 3), 192, 3
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16)
    out, fmap, t, s = ac.fused_attention_block_stats(qkv, H, 0.9, exact)
    p_out, p_map, p_t, _ = ac.block_stats_plain(
        qkv, H, N * N - int(N * N * 0.9), exact)
    own_t, _ = masked_map_stats(fmap, 0.9, exact_discard=exact)
    torch.cuda.synchronize()
    assert torch.equal(t, own_t)
    assert _max_err(s, stats.masked_row_sums(fmap.float(), t.float())) <= 1e-6
    assert _max_err(fmap, p_map) <= _bf16_ulp(p_map)
    assert _max_err(out, p_out) <= 2 * _bf16_ulp(p_out)
    map_diff = (fmap != p_map).flatten(1)
    assert int(map_diff.sum()) <= max(int(1e-4 * fmap.numel()), N)
    t_diff = t != p_t.to(t.dtype)
    assert int(t_diff.sum()) <= 1
    assert bool((map_diff.any(dim=1) | ~t_diff).all())


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("N", _PAST_640 + [2305])
def test_map_stats_past_640_matches_plain(rng, cuda, exact, N):
    """K2 past 640 tokens (B=3, B=2 at 2,305): t bit-equal, s within 1e-6;
    the route is the band in shared memory up to ~850 tokens and the band
    read in place above (``ppf_map_stats_route``)."""
    from protopformer_tpu_torch.kernels import _build

    B = 2 if N > 1601 else 3
    assert _build.library().ppf_map_stats_route(N) == (1 if N <= 850 else 2)
    maps = _prob_maps(rng, B, N).to(cuda)
    if not exact:
        maps = maps.bfloat16()
    t, s = stats.fused_map_stats(maps, 0.9, exact_discard=exact)
    want_t, want_s = stats.fused_map_stats(maps.cpu(), 0.9,
                                           exact_discard=exact)
    assert torch.equal(t.cpu(), want_t)
    assert _max_err(s.cpu(), want_s) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", _PAST_640)
def test_mean_padded_past_640_matches_plain(rng, cuda, dtype, N):
    """K3 past 640 tokens on its global route (the head mean in the map;
    fp32 with P in device memory), held as
    ``test_mean_padded_kernel_matches_plain`` holds it, at B=3."""
    from protopformer_tpu_torch.kernels import _build

    bf16 = int(dtype == torch.bfloat16)
    assert _build.library().ppf_attention_mean_global_route(N, 64, bf16) == 1
    qkv, pol = _qkv_policy(rng, 3, N, N, 192)
    qkv, pol = qkv.to(cuda, dtype), pol.to(cuda)
    out, fmap = ac.fused_attention_mean_padded(qkv, pol, 3, real_n=N)
    p_out, p_map = ac.mean_padded_plain(qkv, pol, 3, real_n=N)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _max_err(out, p_out) <= tol
    assert _max_err(fmap, p_map) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", _PAST_640)
def test_core_past_640_matches_plain(rng, cuda, dtype, N):
    """K4 past 640 tokens (the ones policy, as ``masked_forward_thresh``'s
    pre-prune blocks call it), held by ``_check_core`` at B=3."""
    qkv, pol = _qkv_policy(rng, 3, N, N, 192)
    qkv = qkv.to(cuda, dtype)
    pol = torch.ones_like(pol).to(cuda)
    out, fmap = ac.fused_attention_core(qkv, None, 3, ones_policy=True)
    p_out, p_map = ac.core_plain(qkv, pol, 3)
    _check_core(qkv, pol, 3, N, out, fmap, p_out, p_map)


@pytest.mark.parametrize("dtype,N,NP", [
    (torch.bfloat16, 785, 896), (torch.bfloat16, 1025, 1152),
    (torch.float32, 785, 896), (torch.float32, 1025, 1152),
])
def test_core_padded_past_640_pads_exactly_zero(rng, cuda, dtype, N, NP):
    """K5 on an NP-padded stream past 640 tokens (DeiT-Tiny/16 at 448 and
    512 px, padded to a multiple of 128 as the JAX bench pads): every pad
    row and column of the map exactly 0, the real block held by
    ``_check_core`` at B=3."""
    qkv, pol = _qkv_policy(rng, 3, N, NP, 192)
    qkv, pol = qkv.to(cuda, dtype), pol.to(cuda)
    out, fmap = ac.fused_attention_core_padded(qkv, pol, 3, N)
    p_out, p_map = ac.core_padded_plain(qkv, pol, 3, N)
    _check_core(qkv, pol, 3, N, out, fmap, p_out, p_map)


def test_deit_tiny_served_at_448_matches_the_cpu(cuda):
    """F9's repair: a DeiT-Tiny/16 PPNet at 448 px (785 tokens) served on
    the card in fp32 parity (K3 x 12, K2 x 11 per forward) against the CPU
    forward on 2 images: logits within 1e-4, the same top-81 tokens,
    cls_token_attn within 1e-5."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.serving import ServingEngine

    bk = backbone_preset("deit_tiny_patch16_224", img_size=448)
    pp = PPNetConfig()
    state = construct_ppnet(bk, pp, torch.float32,
                            generator=torch.Generator().manual_seed(11)
                            ).state_dict()
    imgs = np.random.default_rng(12).integers(0, 256, (2, 448, 448, 3),
                                              dtype=np.uint8)
    res = {}
    for device in ("cpu", cuda):
        kernels.reset_launch_counts()
        res[str(device)] = ServingEngine(bk, pp, state, batch_size=2,
                                         compute_dtype=torch.float32,
                                         with_attn=True, device=device)(imgs)
    counts = kernels.launch_counts()
    assert counts["fused_attention_mean_padded"] == 12
    assert counts["fused_map_stats"] == 11
    got, want = res["cuda"], res["cpu"]
    assert float(np.abs(got.logits - want.logits).max()) <= 1e-4
    assert float(np.abs(got.cls_token_attn - want.cls_token_attn).max()) <= 1e-5
    for a, b in zip(got.cls_token_attn, want.cls_token_attn):
        assert set(np.argsort(-a)[:81]) == set(np.argsort(-b)[:81])


_DIV_CHECK = r"""
#include <cstdio>
#include <cstdlib>
#include "common.cuh"
__device__ unsigned long long bad;
__device__ void count(float x, float d, float y) {
  if (__float_as_uint(ppf::div_by_recip(x, d, y)) !=
      __float_as_uint(__fdiv_rn(x, d)))
    atomicAdd(&bad, 1ull);
}
__global__ void check(float d, unsigned lo, unsigned n) {
  const float y = __frcp_rn(d);
  if (blockIdx.x == 0 && threadIdx.x == 0) count(0.f, d, y);
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    count(__uint_as_float(lo + i), d, y);
}
int main(int argc, char** argv) {
  unsigned long long total = 0;
  for (int k = 1; k < argc; ++k) {
    unsigned long long zero = 0, n = 0;
    cudaMemcpyToSymbol(bad, &zero, sizeof(zero));
    check<<<1320, 256>>>(strtof(argv[k], nullptr), 0x2B800000u,
                         0x40800000u - 0x2B800000u);
    if (cudaMemcpyFromSymbol(&n, bad, sizeof(n)) != cudaSuccess) return 2;
    total += n;
  }
  printf("%llu\n", total);
  return 0;
}
"""


def test_division_by_reciprocal_matches_div_rn(cuda, tmp_path):
    """K4/K5's normalize divides by a correctly rounded reciprocal with two
    FMA corrections (``common.cuh::div_by_recip``): bit-equal to
    ``__fdiv_rn`` for +0 and every fp32 numerator in [2^-40, 4), over
    1 + identity_weight = 1.2 and 15 seeded divisors in [0.15, 100)."""
    from protopformer_tpu_torch.kernels import _build

    src, exe = tmp_path / "div_check.cu", tmp_path / "div_check"
    src.write_text(_DIV_CHECK)
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-I", str(_build.CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True, timeout=300)
    divisors = [1.2] + list(np.random.default_rng(7).uniform(0.15, 100.0, 15))
    out = subprocess.run([str(exe), *(repr(float(np.float32(d)))
                                      for d in divisors)],
                         check=True, capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "0"


# --- CaiT: no kernel of kernels/ on its path -----------------------------------------

def _cait_ppnet(cfg_overrides=None, dtype=torch.float32):
    """A seeded CaiT-XXS-24 PPNet (2000 + 2000 prototypes of width 192,
    reserve at class-attention block 1 keeping 81) in eval mode."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet

    bk = backbone_preset("cait_xxs24_224", **(cfg_overrides or {}))
    pp = PPNetConfig(reserve_layers=(1,), reserve_token_nums=(81,))
    return construct_ppnet(bk, pp, dtype,
                           generator=torch.Generator().manual_seed(3)).eval()


def test_cait_forward_on_the_card_matches_the_cpu(rng, cuda):
    """fp32 with TF32 off, B=3: the same top-81 tokens, cls_token_attn
    within 1e-5, logits within 1e-4."""
    from protopformer_tpu_torch.serving import no_tf32

    model = _cait_ppnet()
    x = torch.from_numpy(rng.normal(size=(3, 224, 224, 3)).astype(np.float32))
    with torch.inference_mode():
        want = model(x)
        with no_tf32():
            got = model.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    attn, want_attn = got.cls_token_attn.cpu(), want.cls_token_attn
    assert torch.equal(attn.topk(81).indices.sort().values,
                       want_attn.topk(81).indices.sort().values)
    assert _max_err(attn, want_attn) <= 1e-5
    assert _max_err(got.logits.cpu(), want.logits) <= 1e-4


@pytest.mark.parametrize("dtype,exact", [(torch.float32, True),
                                         (torch.bfloat16, True),
                                         (torch.bfloat16, False)])
def test_cait_forward_launches_no_kernel(cuda, dtype, exact):
    """A CaiT forward in each mode launches none of K1-K5: its blocks are
    not the DeiT ``Attention`` and its signed statistics are plain."""
    model = _cait_ppnet({"rollout_exact_discard": exact}, dtype).to(cuda)
    x = torch.zeros((2, 224, 224, 3), device=cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    assert set(kernels.launch_counts().values()) == {0}
    assert bool(torch.isfinite(out.logits).all())


# --- the kernel-off structure, the unpruned forwards, push_forward ----------

def _assert_tie_free(scores, k):
    """The k-th and (k+1)-th largest score of every row differ, so the
    top-k set does not depend on how each device breaks ties."""
    top = scores.topk(k + 1).values
    assert bool((top[:, k - 1] > top[:, k]).all())


def _micro_ppnet(dtype, **overrides):
    """A seeded micro PPNet (img 32, dim 24, 2 heads, depth 3, discard 0.7,
    prune at block 2 keeping 9 of 16) on the CPU."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet

    # trap F2: a 0.7 discard keeps the micro top-9 sets tie-free
    bk = backbone_preset("deit_micro_test", rollout_discard_ratio=0.7,
                         **overrides)
    pp = PPNetConfig(prototype_shape=(40, 16, 1, 1), num_classes=4,
                     reserve_layers=(2,), reserve_token_nums=(9,),
                     global_proto_per_class=3)
    return construct_ppnet(bk, pp, dtype,
                           generator=torch.Generator().manual_seed(6))


@pytest.mark.parametrize("overrides,k2", [
    ({"use_pallas": "off", "rollout_exact_discard": False}, 2),
    ({"use_pallas": "off", "stats_kernel": "off"}, 0),
    ({"rollout_head_fusion": "max"}, 2),
], ids=["off-speed-k2", "off-plain-stats", "max-fusion"])
def test_kernel_off_structure_launches_only_what_it_implies(cuda, overrides,
                                                            k2):
    """No attention kernel; K2 on each pre-prune map when ``stats_kernel``
    is on. With exact discard the fp32 logits are within 1e-4 of the
    CPU's forward; the speed discard's 16-bit prefix threshold over 17
    tokens can move with one bf16 rounding of the map, so there only the
    logits' finiteness is held."""
    from protopformer_tpu_torch.serving import no_tf32

    model = _micro_ppnet(torch.float32, **overrides).eval()
    x = torch.zeros((3, 32, 32, 3)).normal_(generator=torch.Generator()
                                            .manual_seed(7))
    with torch.inference_mode():
        want = model(x)
        kernels.reset_launch_counts()
        with no_tf32():
            got = model.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts.pop("fused_map_stats") == k2
    assert set(counts.values()) == {0}
    assert bool(torch.isfinite(got.logits).all())
    if overrides.get("rollout_exact_discard", True):
        _assert_tie_free(want.cls_token_attn, 9)
        assert _max_err(got.logits.cpu(), want.logits) <= 1e-4


def test_unpruned_forwards_and_push_forward_on_the_card(cuda):
    """``forward_features`` launches no kernel; ``push_forward`` launches
    the eval forward's kernels and matches the CPU's in fp32."""
    from protopformer_tpu_torch.serving import no_tf32

    model = _micro_ppnet(torch.float32).eval()
    x = torch.zeros((3, 32, 32, 3)).normal_(generator=torch.Generator()
                                            .manual_seed(8))
    want = model.push_forward(x)
    _assert_tie_free(want.cls_token_attn, 9)
    with torch.inference_mode():
        want_feat = model.features.forward_features(x)
    model = model.to(cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode(), no_tf32():
        feat = model.features.forward_features(x.to(cuda))
    assert set(kernels.launch_counts().values()) == {0}
    with no_tf32():
        got = model.push_forward(x.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_map_stats"] == 2
    assert _max_err(feat.cpu(), want_feat) <= 1e-4
    assert _max_err(got.cls_token_attn.cpu(), want.cls_token_attn) <= 1e-5
    assert _max_err(got.proto_acts.cpu(), want.proto_acts) <= 1e-4


# --- training: the train forward runs K2 and no attention kernel ------------

def _micro_train(dtype, device):
    """A seeded micro PPNet (img 32, dim 24, depth 3, prune at block 2
    keeping 9 of 16, drop path 0), its train state and train step."""
    from protopformer_tpu_torch import train
    from protopformer_tpu_torch.core.config import (
        OptimConfig,
        PPNetConfig,
        backbone_preset,
    )
    from protopformer_tpu_torch.models import construct_ppnet

    bk = backbone_preset("deit_micro_test", rollout_discard_ratio=0.7,
                         drop_path_rate=0.0)
    pp = PPNetConfig(prototype_shape=(40, 16, 1, 1), num_classes=4,
                     reserve_layers=(2,), reserve_token_nums=(9,),
                     global_proto_per_class=3)
    opt = OptimConfig(epochs=10, warmup_epochs=0, features_lr=1e-3)
    model = construct_ppnet(bk, pp, dtype,
                            generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(
        model, train.make_optimizer(opt, model, 4), device=device)
    return state, train.make_train_step(model, pp, opt, device=device)


def _micro_batch(rng, n=4):
    return {"image": rng.uniform(size=(n, 32, 32, 3)).astype(np.float32),
            "label": np.arange(n) % 4}


def test_train_step_on_the_card_matches_the_cpu(rng, cuda):
    """fp32 (TF32 off), PPC on: the loss within 1e-5, every gradient within
    2e-4 * max|g| + 1e-7, and the card's parameters after the AdamW step
    within 1e-6 of the CPU's AdamW step from the same weights on the
    card's gradients. (Against the CPU's own step an entry whose gradient
    is within a few eps of 0, such as a key bias's, may move by up to lr:
    AdamW's first step is lr * g / (|g| + eps).)"""
    batch = _micro_batch(rng)
    results = []
    for device in ("cpu", cuda):
        state, step = _micro_train(torch.float32, device)
        state, metrics = step(state, batch,
                              torch.Generator(device).manual_seed(0), 1.0)
        torch.cuda.synchronize()
        results.append((float(metrics["loss"]),
                        {n: (p.detach().cpu(), None if p.grad is None
                             else p.grad.cpu())
                         for n, p in state.model.named_parameters()}))
    (cpu_loss, cpu), (card_loss, card) = results
    replay, _ = _micro_train(torch.float32, "cpu")
    for name, p in replay.model.named_parameters():
        p.grad = None if card[name][1] is None else card[name][1].clone()
    replay.apply_gradients()
    replayed = dict(replay.model.named_parameters())
    assert abs(card_loss - cpu_loss) <= 1e-5
    for name, (p, g) in cpu.items():
        q, h = card[name]
        assert (g is None) == (h is None), name
        if g is not None:
            tol = 2e-4 * max(float(g.abs().max()), 1e-8) + 1e-7
            assert _max_err(h, g) <= tol, name
        assert _max_err(q, replayed[name].detach()) <= 1e-6, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_train_step_launches_k2_per_pre_prune_block(rng, cuda, dtype):
    """One train step launches K2 once per pre-prune block (2 here) and
    none of the attention kernels; the fp32 eval step keeps the serving
    launches (K3 on every block, K2 on the pre-prune ones)."""
    from protopformer_tpu_torch import train

    state, step = _micro_train(dtype, cuda)
    batch = _micro_batch(rng)
    gen = torch.Generator(cuda).manual_seed(0)
    step(state, batch, gen, 1.0)
    kernels.reset_launch_counts()
    _, metrics = step(state, batch, gen, 1.0)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts.pop("fused_map_stats") == 2
    assert set(counts.values()) == {0}
    assert math.isfinite(float(metrics["loss"]))
    if dtype == torch.float32:
        kernels.reset_launch_counts()
        train.make_eval_step(device=cuda)(state.model, batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["fused_attention_mean_padded"] == 3
        assert counts["fused_map_stats"] == 2


# --- the offline user path: the train CLI and the consistency tool --------

_CLI_MICRO = [
    "--base_architecture=deit_micro_test", "--data_set=synthetic",
    "--data_path=", "--img_size=32", "--input_size=32", "--batch_size=8",
    "--warmup-epochs=1", "--prototype_shape", "8", "16", "1", "1",
    "--reserve_layers", "2", "--reserve_token_nums", "9",
    "--global_proto_per_class=2", "--num_workers=2",
    "--compute_dtype=float32", "--save_ep_freq=1", "--use_ppc_loss=True",
]


def test_cli_train_resume_and_eval_on_the_card(cuda, tmp_path, monkeypatch):
    """``cli.train`` on its default device: 2 epochs (drop path 0.1), a
    resume of epoch 1 from epoch 0's file that ends with the continuous
    run's step and generator state, and ``--eval`` of the saved epoch
    reproducing its logged acc1 and loss exactly. Each train step launches
    K2 on the 2 pre-prune blocks, each fp32 eval batch K3 x 3 + K2 x 2.
    (The parameters are not compared bit for bit: the backward's
    scatter-adds sum in any order on the card.)"""
    import json
    import os
    import sys

    from protopformer_tpu_torch.cli import train as train_cli

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    def run(*flags):
        kernels.reset_launch_counts()
        out = train_cli.main(train_cli.get_args_parser().parse_args(
            [*_CLI_MICRO, *flags]))
        torch.cuda.synchronize()
        return out, kernels.launch_counts()

    _, counts = run("--epochs=2", f"--output_dir={tmp_path}/a")
    # 64 images: 8 steps and 6 eval batches of 12 (the last padded) an epoch
    assert counts["fused_map_stats"] == 2 * (8 * 2 + 6 * 2)
    assert counts["fused_attention_mean_padded"] == 2 * 6 * 3
    run("--epochs=2", f"--resume={tmp_path}/a/checkpoints/checkpoint-0.pth",
        f"--output_dir={tmp_path}/b")
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)  # noqa: E731
    want = load(f"{tmp_path}/a/checkpoints/checkpoint-1.pth")
    got = load(f"{tmp_path}/b/checkpoints/checkpoint-1.pth")
    assert got["step"] == want["step"] == 16
    assert torch.equal(got["generator"], want["generator"])
    assert all(bool(torch.isfinite(v).all()) for v in got["model"].values())
    stats, counts = run("--epochs=2", "--eval",
                        f"--resume={tmp_path}/a/checkpoints/checkpoint-1.pth",
                        f"--output_dir={tmp_path}/c")
    with open(os.path.join(tmp_path, "a", "metrics.jsonl")) as f:
        logged = [r for r in map(json.loads, f) if "epoch/val_acc1" in r][-1]
    assert stats["acc1"] == logged["epoch/val_acc1"]
    assert stats["loss"] == logged["epoch/val_loss"]
    assert counts["fused_attention_mean_padded"] == 6 * 3


def test_consistency_score_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``consistency_score`` of the fp32 micro PPNet on the card (TF32 off,
    K3 and K2 launched) equals the CPU's: the same per-prototype part hits
    and visibility counts, so the same score; the thread pool is
    bit-neutral on the card too."""
    from protopformer_tpu_torch.data.local_parts import CubPartAnnotations
    from protopformer_tpu_torch.tools import eval_interpretability as tool

    rng = np.random.default_rng(12)
    images = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    ids = np.arange(1, 17)
    annotations = CubPartAnnotations(
        id_to_path={}, id_to_bbox={},
        id_to_part_loc={int(i): [(int(p) + 1, int(rng.integers(0, 64)),
                                  int(rng.integers(0, 64)))
                                 for p in rng.choice(15, 6, replace=False)]
                        for i in ids})
    sizes = {int(i): (64, 64) for i in ids}
    labels = np.arange(16) % 4

    def loader():
        for s in range(0, 16, 8):
            yield {"image": images[s:s + 8], "label": labels[s:s + 8],
                   "valid": np.ones(8, np.float32),
                   "position": np.arange(s, s + 8)}

    sums = []
    real = tool.aggregate_score
    monkeypatch.setattr(tool, "aggregate_score", lambda h, v, t: (
        sums.append((h.copy(), v.copy())), real(h, v, t))[1])
    from protopformer_tpu_torch.tools.visualize import push

    model = _micro_ppnet(torch.float32).eval()
    _assert_tie_free(push(model, images).cls_token_attn, 9)
    cfg = tool.ConsistencyConfig(half_size=8, img_size=32)
    args = (loader, annotations, ids, sizes, model.config, cfg)

    def score(m, **kw):
        return tool.consistency_score(m, args[0](), *args[1:], **kw)

    want = score(model)
    model.to(cuda)
    kernels.reset_launch_counts()
    got = score(model)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_attention_mean_padded"] == 2 * 3
    pooled = score(model, host_workers=4)
    assert got == want == pooled
    for a, b in zip(sums[1], sums[0]):
        np.testing.assert_array_equal(a, b)
    assert 0 < sums[0][0].sum() < sums[0][1].sum()


# --- several cards: the mesh engine, data-parallel steps; int8 serving -------

def _tiny_224(dtype, **overrides):
    """DeiT-Tiny/16@224 at the CUB head, seeded weights, and its config."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet

    bk = backbone_preset("deit_tiny_patch16_224", **overrides)
    pp = PPNetConfig()
    model = construct_ppnet(bk, pp, dtype,
                            generator=torch.Generator().manual_seed(3))
    return bk, pp, model.state_dict()


def _top81(attn):
    return [set(np.argsort(-row)[:81].tolist()) for row in attn]


def test_mesh_engine_sharing_the_card_equals_one_device(rng, cuda):
    """Two replicas on one card (8 images each): fp32 logits within 1e-5
    of the one-device engine's, the same top-81, and a chunk's launches
    twice a one-device chunk's."""
    from protopformer_tpu_torch.parallel import make_mesh
    from protopformer_tpu_torch.serving import ServingEngine

    bk, pp, sd = _tiny_224(torch.float32)
    kw = dict(compute_dtype=torch.float32, with_attn=True)
    single = ServingEngine(bk, pp, sd, batch_size=8, device=cuda, **kw)
    mesh = ServingEngine(bk, pp, sd, batch_size=8,
                         mesh=make_mesh([cuda, cuda]), **kw)
    assert mesh.batch_size == 16 and len(mesh.models) == 2
    imgs = rng.integers(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    kernels.reset_launch_counts()
    single(imgs[:8])
    torch.cuda.synchronize()
    one_chunk = kernels.launch_counts()
    kernels.reset_launch_counts()
    got = mesh(imgs)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {k: 2 * v for k, v in one_chunk.items()}
    assert one_chunk["fused_attention_mean_padded"] == 12
    want = single(imgs)
    assert _max_err(torch.from_numpy(got.logits),
                    torch.from_numpy(want.logits)) <= 1e-5
    assert _top81(got.cls_token_attn) == _top81(want.cls_token_attn)
    np.testing.assert_array_equal(got.top_class, want.top_class)


def _ddp_job(tmp_path, devices, backend):
    """The job of the data-parallel worker; the kernels are built here,
    once, so that no two ranks start ``nvcc`` on the same directory."""
    from protopformer_tpu_torch.kernels import _build
    from tests import torch_ddp_common as common

    _build.build()

    model = common.construct_ppnet(common.BACKBONE, common.PPNET,
                                   torch.float32,
                                   generator=torch.Generator().manual_seed(0))
    weights = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), weights)
    return {"weights": weights, "devices": devices, "backend": backend,
            "optim": dict(epochs=2, warmup_epochs=1, model_ema=False,
                          clip_grad=0.01),
            "local_b": 4, "eval_b": 4, "seed": 1028,
            "out": str(tmp_path / "rank")}


def test_two_gloo_ranks_sharing_the_card_match_the_one_process_step(
        cuda, tmp_path):
    """Two processes over gloo on one card (NCCL refuses two ranks on one
    device), fp32 with TF32 off, ``clip_grad`` set: the all-reduced loss
    equal on both ranks and within 1e-5 of the one-process card step on
    the global batch, every gradient within 2e-4 * max|g| + 1e-7, and the
    ranks' parameters within 1e-6 of the card's AdamW step from the same
    weights on their gradients."""
    from protopformer_tpu_torch.core.config import OptimConfig
    from protopformer_tpu_torch.parallel import shard_index_for_process
    from tests import torch_ddp_common as common

    job = _ddp_job(tmp_path, ["cuda:0", "cuda:0"], "gloo")
    outs = common.run_workers(job, tmp_path)
    assert {o["backend"] for o in outs} == {"gloo"}
    assert outs[0]["loss"] == outs[1]["loss"]
    ranks = [torch.load(f"{job['out']}.{r}.pt") for r in range(2)]
    index = common.train_index()
    parts = [common.local_rows(shard_index_for_process(index, r, 2), 4)
             for r in range(2)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    optim = OptimConfig(**job["optim"])
    model, state, step = common.model_and_state(job["weights"], optim, cuda)
    _, metrics = step(state, batch, torch.Generator(cuda).manual_seed(0), 1.0)
    assert abs(float(metrics["loss"]) - ranks[0]["metrics"]["loss"]) <= 1e-5
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        tol = 2e-4 * max(float(p.grad.abs().max()), 1e-8) + 1e-7
        assert _max_err(ranks[0]["grads"][name], p.grad.cpu()) <= tol, name
    replay, rstate, _ = common.model_and_state(job["weights"], optim, cuda)
    for name, p in replay.named_parameters():
        g = ranks[0]["grads"].get(name)
        p.grad = None if g is None else g.to(cuda)
    rstate.apply_gradients()
    for name, p in replay.state_dict().items():
        assert _max_err(ranks[0]["params"][name], p.cpu()) <= 1e-6, name
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name])
    sums = ranks[0]["sums"]
    assert sums["n"] == common.EVAL_SAMPLES == ranks[1]["sums"]["n"]


def test_an_nccl_world_of_every_card_runs_one_step(cuda, tmp_path):
    """``torch.cuda.device_count()`` ranks over NCCL, one card each (a
    group of one on a one-card machine): one step, the same finite loss on
    every rank."""
    from tests import torch_ddp_common as common

    world = torch.cuda.device_count()
    job = _ddp_job(tmp_path, [f"cuda:{r}" for r in range(world)], "nccl")
    outs = common.run_workers(job, tmp_path, world=world)
    assert {o["backend"] for o in outs} == {"nccl"}
    assert {o["world"] for o in outs} == {world}
    assert len({o["loss"] for o in outs}) == 1
    assert math.isfinite(outs[0]["loss"])


def test_int8_matmul_on_the_card_matches_the_cpu(rng, cuda):
    """``torch._int_mm`` on the card: the int32 product is exact, so the
    output is the CPU's within 1e-6 * max|out|; a shape outside its CUDA
    rules raises with its cause."""
    from protopformer_tpu_torch.ops.quant import int8_matmul

    x = torch.from_numpy(rng.normal(size=(160, 82, 192)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(192, 576)).astype(np.float32))
    want = int8_matmul(x, w)
    got = int8_matmul(x.to(cuda), w.to(cuda)).cpu()
    assert _max_err(got, want) <= 1e-6 * float(want.abs().max())
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_matmul(x[:1, :8].to(cuda), w.to(cuda))


def test_int8_serving_on_the_card_keeps_the_bf16_selection_contract(
        rng, cuda):
    """``quantize="int8"`` in bf16 speed mode: the card's forward against
    the CPU's int8 forward on 2 images, by serving's bf16 contract (at
    least 74 of the top-81 kept, none of rank below 64 dropped, logits
    within rtol 2e-2 plus 2e-2 * max|logits|); a chunk launches K1 x 11 and
    K3 x 1."""
    from protopformer_tpu_torch.serving import ServingEngine

    bk, pp, sd = _tiny_224(torch.bfloat16, quantize="int8",
                           rollout_exact_discard=False)
    imgs = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    kw = dict(batch_size=2, compute_dtype=torch.bfloat16, with_attn=True)
    cpu = ServingEngine(bk, pp, sd, device="cpu", **kw)(imgs)
    engine = ServingEngine(bk, pp, sd, device=cuda, **kw)
    kernels.reset_launch_counts()
    card = engine(imgs)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fused_attention_block_stats"] == 11
    assert counts["fused_attention_mean_padded"] == 1
    order = np.argsort(-cpu.cls_token_attn, axis=-1)
    for b, got in enumerate(_top81(card.cls_token_attn)):
        want = set(order[b, :81].tolist())
        rank = {int(t): r for r, t in enumerate(order[b])}
        assert len(want & got) >= 74
        assert all(rank[t] >= 64 for t in want - got)
    atol = 2e-2 * float(np.abs(cpu.logits).max())
    np.testing.assert_allclose(card.logits, cpu.logits, rtol=2e-2, atol=atol)
