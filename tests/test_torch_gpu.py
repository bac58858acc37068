"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips it where no CUDA device exists. The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed; on such a
machine run it without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: thresholds t bit-equal, row sums 1e-6, fp32 outputs 1e-5 and
maps 1e-6 (those of the JAX package's kernel tests); K1's map bit-equal to
its plain version and its bf16 output within one bf16 ulp of the largest
output; K3's bf16 output 1e-2. K4/K5 emit a map normalized after a k-th
largest discard, where a one-ulp difference in the raw map can move an
entry across the threshold: each is held against the plain normalize of
K3's raw map on the same inputs (the same device code, so the same raw
map: identical kept entries, map within 1e-6), and against its plain
version (out as above; map within 1e-6 on every sample whose kept entries
agree).
"""

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


def _prob_maps(rng, B, N):
    maps = rng.uniform(size=(B, N, N)).astype(np.float32)
    return torch.from_numpy(maps / maps.sum(-1, keepdims=True))


def _qkv_policy(rng, B, N, NP, C):
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    pol = (rng.uniform(size=(B, N)) > 0.4).astype(np.float32)
    pol[:, 0] = 1.0
    qkv = np.pad(qkv, ((0, 0), (0, NP - N), (0, 0)))
    return torch.from_numpy(qkv), torch.from_numpy(np.pad(pol, ((0, 0), (0, NP - N))))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("N,C,H", [(197, 192, 3), (24, 16, 2)])
def test_block_stats_kernel_matches_plain(rng, cuda, exact, N, C, H):
    qkv = torch.from_numpy(rng.normal(size=(8, N, 3 * C)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16)
    before = kernels.launch_counts()["fused_attention_block_stats"]
    out, fmap, t, s = ac.fused_attention_block_stats(qkv, H, 0.9, exact)
    assert kernels.launch_counts()["fused_attention_block_stats"] == before + 1
    p_out, p_map, p_t, p_s = ac.block_stats_plain(
        qkv, H, N * N - int(N * N * 0.9), exact
    )
    own_t, _ = masked_map_stats(fmap, 0.9, exact_discard=exact)
    torch.cuda.synchronize()
    # the kernel rounds where the plain version does: map and t bit-equal
    assert torch.equal(fmap, p_map)
    assert torch.equal(t, p_t.to(t.dtype))
    assert torch.equal(t, own_t)
    assert _max_err(s, p_s) <= 1e-6
    # probs @ v may sum its fp32 products in another order than cuBLAS:
    # at most one bf16 ulp of the largest output apart
    assert _max_err(out, p_out) <= 2.0 ** -8 * float(p_out.float().abs().max())


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("N", [197, 24])
def test_map_stats_kernel_matches_plain(rng, cuda, exact, N):
    maps = _prob_maps(rng, 8, N).to(cuda)
    if not exact:
        maps = maps.bfloat16()
    t, s = stats.fused_map_stats(maps, 0.9, exact_discard=exact)
    want_t, want_s = stats.fused_map_stats(maps.cpu(), 0.9, exact_discard=exact)
    assert torch.equal(t.cpu(), want_t)
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
    with pytest.raises(ValueError):
        stats.fused_map_stats(torch.zeros((2, 300, 300), device=cuda), 0.9)
    # the normalize phase holds the real block: real_n <= 240
    with pytest.raises(ValueError, match="shared memory"):
        ac.fused_attention_core_padded(
            torch.zeros((2, 256, 48), device=cuda),
            torch.ones((2, 256), device=cuda), 2, 250,
        )
