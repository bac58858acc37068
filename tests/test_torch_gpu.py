"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips it where no CUDA device exists. The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed; on such a
machine run it without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: thresholds t bit-equal, row sums 1e-6, fp32 outputs 1e-5 and
maps 1e-6 (those of the JAX package's kernel tests); K3's bf16 output 1e-2.
K1 sums the dots of QK^T on tensor cores, in another order than the plain
version's fp32 matmul, and rounds each logit to bf16 at once: a logit can
then land one bf16 ulp away and move its row of the map, so the map is not
bit-equal to the plain version's, and t, an order statistic of the map,
may differ from the plain t as well. K1 is held as chip_smoke.py holds it:
t bit-equal to masked_map_stats on the kernel's own map and s within 1e-6
of that map's masked row sums; against the plain version the map within
one bf16 ulp of its largest entry, out within 2 bf16 ulps of max|out|, at
most 1e-4 of the map's entries (or one row) differing, and t differing in
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
@pytest.mark.parametrize("N,C,H", [(197, 192, 3), (24, 16, 2), (40, 64, 2)])
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
    assert int(map_diff.sum()) <= max(int(1e-4 * fmap.numel()), N)
    t_diff = t != p_t.to(t.dtype)
    assert int(t_diff.sum()) <= max(1, B // 80)
    assert bool((map_diff.any(dim=1) | ~t_diff).all())


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("exact", [True, False])
# one CTA a sample at 17 and 24 tokens, a cluster of 2 at 82 and 4 at 197
# (bands of 49-50 rows) and 256 (64 rows)
@pytest.mark.parametrize("N", [17, 24, 82, 197, 256])
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
])
def test_core_padded_kernel_matches_plain(rng, cuda, dtype, N, NP, C, H):
    qkv, pol = _qkv_policy(rng, 8, N, NP, C)
    qkv, pol = qkv.to(cuda, dtype), pol.to(cuda)
    before = kernels.launch_counts()["fused_attention_core_padded"]
    out, fmap = ac.fused_attention_core_padded(qkv, pol, H, N)
    assert kernels.launch_counts()["fused_attention_core_padded"] == before + 1
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
    # every kernel takes at most 256 tokens
    with pytest.raises(ValueError, match="at most 256"):
        stats.fused_map_stats(torch.zeros((2, 257, 257), device=cuda), 0.9)
    with pytest.raises(ValueError, match="at most 256"):
        ac.fused_attention_core(torch.zeros((2, 257, 48), device=cuda),
                                None, 2, ones_policy=True)
    with pytest.raises(ValueError, match="at most 256"):
        ac.fused_attention_core_padded(
            torch.zeros((2, 264, 48), device=cuda),
            torch.ones((2, 264), device=cuda), 2, 250,
        )


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
