"""K1-K5 of the PyTorch port against the JAX package's Pallas kernels.

On the CPU each public kernel function runs its plain PyTorch version; the
JAX kernels run in interpret mode, as tests/test_kernels.py runs them.
The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_gpu.py.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.kernels import attention_core as j_ac
from protopformer_tpu.kernels import stats as j_stats
from protopformer_tpu.ops import rollout as j_roll
from protopformer_tpu_torch import kernels as t_kernels
from protopformer_tpu_torch.kernels import attention_core as t_ac
from protopformer_tpu_torch.kernels import stats as t_stats
from protopformer_tpu_torch.ops import rollout as t_roll
from tests.torch_port import to_np


def _prob_maps(rng, B, N):
    maps = rng.uniform(size=(B, N, N)).astype(np.float32)
    return maps / maps.sum(-1, keepdims=True)


# --- K1: fused_attention_block_stats -------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
def test_block_stats_plain_matches_jax_kernel(rng, exact):
    """Mirrors tests/test_kernels.py::test_fused_attention_block_stats_contract:
    t bit-equal to masked_map_stats on the emitted map, s within 1e-6, the
    map within 1e-2 and out within 5e-2 of the JAX kernel's."""
    B, N, C, H = 4, 24, 16, 2
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    w_out, w_map, w_t, w_s = j_ac.fused_attention_block_stats(
        jnp.asarray(qkv).astype(jnp.bfloat16), H, 0.9, exact_discard=exact,
        interpret=True,
    )
    out, fmap, t, s = t_ac.fused_attention_block_stats(
        torch.from_numpy(qkv).bfloat16(), H, 0.9, exact_discard=exact
    )
    map_dtype = torch.float32 if exact else torch.bfloat16
    assert fmap.dtype == map_dtype and t.dtype == map_dtype
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32

    # the lazy-rollout contract on the emitted map, both frameworks' ops
    want_t, want_s = t_roll.masked_map_stats(fmap, 0.9, exact_discard=exact)
    np.testing.assert_array_equal(to_np(t), to_np(want_t))
    np.testing.assert_allclose(to_np(s), to_np(want_s), atol=1e-6)
    j_map = jnp.asarray(to_np(fmap)).astype(
        jnp.float32 if exact else jnp.bfloat16
    )
    jt, js = j_roll.masked_map_stats(j_map, 0.9, exact_discard=exact)
    np.testing.assert_array_equal(to_np(t), to_np(jt))
    np.testing.assert_allclose(to_np(s), to_np(js), atol=1e-6)

    np.testing.assert_allclose(to_np(fmap), to_np(w_map), atol=1e-2)
    np.testing.assert_allclose(to_np(out), to_np(w_out), atol=5e-2)


def test_block_stats_rejects_inactive_discard(rng):
    qkv = torch.zeros((1, 8, 12), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="active discard"):
        t_ac.fused_attention_block_stats(qkv, 2, 0.0)


# --- K2: fused_map_stats -------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
def test_map_stats_plain_matches_jax_kernel(rng, exact):
    """Mirrors tests/test_kernels.py::test_fused_map_stats_matches_masked_map_stats."""
    maps = _prob_maps(rng, 4, 24)
    j_in, t_in = jnp.asarray(maps), torch.from_numpy(maps)
    if not exact:
        j_in, t_in = j_in.astype(jnp.bfloat16), t_in.bfloat16()
    want_t, want_s = j_stats.fused_map_stats(
        j_in, 0.9, exact_discard=exact, interpret=True
    )
    got_t, got_s = t_stats.fused_map_stats(t_in, 0.9, exact_discard=exact)
    assert got_t.dtype == t_in.dtype
    np.testing.assert_array_equal(to_np(got_t), to_np(want_t))
    np.testing.assert_allclose(to_np(got_s), to_np(want_s), atol=1e-6)


def test_map_stats_plain_padded_keep_elements(rng):
    """Mirrors tests/test_kernels.py::test_fused_map_stats_padded_keep_elements."""
    B, NR, NP = 4, 17, 24
    maps = np.zeros((B, NP, NP), np.float32)
    maps[:, :NR, :NR] = rng.uniform(size=(B, NR, NR)).astype(np.float32)
    want_t, want_s = j_stats.fused_map_stats(
        jnp.asarray(maps), 0.9, exact_discard=True, keep_elements=NR * NR,
        interpret=True,
    )
    got_t, got_s = t_stats.fused_map_stats(
        torch.from_numpy(maps), 0.9, exact_discard=True, keep_elements=NR * NR
    )
    np.testing.assert_array_equal(to_np(got_t), to_np(want_t))
    np.testing.assert_allclose(to_np(got_s), to_np(want_s), atol=1e-6)
    assert float(got_t.min()) > 0.0


def test_map_stats_no_discard_sentinel_launches_nothing(rng):
    maps = torch.from_numpy(_prob_maps(rng, 2, 8))
    t_kernels.reset_launch_counts()
    t, s = t_stats.fused_map_stats(maps, 0.0)
    assert torch.isneginf(t).all()
    np.testing.assert_allclose(to_np(s), to_np(maps.sum(-1)), atol=1e-6)
    assert t_kernels.launch_counts()["fused_map_stats"] == 0


# --- K3: fused_attention_mean_padded -------------------------------------------

def _qkv_policy(rng, B, N, C, ones):
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    if ones:
        pol = np.ones((B, N), np.float32)
    else:
        pol = (rng.uniform(size=(B, N)) > 0.4).astype(np.float32)
        pol[:, 0] = 1.0
    return qkv, pol


@pytest.mark.parametrize("ones", [True, False])
def test_mean_padded_plain_matches_jax_kernel_fp32(rng, ones):
    """Mirrors tests/test_kernels.py::test_fused_attention_mean_padded_matches_jax
    on padded operands (NP > real_n): out within 1e-5, map within 1e-6, pads
    of the map exactly 0."""
    B, N, NP, C, H = 4, 17, 24, 24, 2
    qkv, pol = _qkv_policy(rng, B, N, C, ones)
    qkv_pad = np.pad(qkv, ((0, 0), (0, NP - N), (0, 0)))
    pol_pad = np.pad(pol, ((0, 0), (0, NP - N)))
    w_out, w_map = j_ac.fused_attention_mean_padded(
        jnp.asarray(qkv_pad), jnp.asarray(pol_pad), H, real_n=N,
        compute_dtype=jnp.float32, interpret=True,
    )
    out, fmap = t_ac.fused_attention_mean_padded(
        torch.from_numpy(qkv_pad), torch.from_numpy(pol_pad), H, real_n=N
    )
    assert out.dtype == torch.float32 and fmap.dtype == torch.float32
    np.testing.assert_allclose(to_np(out)[:, :N], to_np(w_out)[:, :N], atol=1e-5)
    np.testing.assert_allclose(to_np(fmap), to_np(w_map), atol=1e-6)
    assert np.abs(to_np(fmap)[:, N:]).max() == 0.0
    assert np.abs(to_np(fmap)[:, :, N:]).max() == 0.0


def test_mean_padded_plain_matches_jax_kernel_bf16(rng):
    B, N, C, H = 4, 24, 16, 2
    qkv, pol = _qkv_policy(rng, B, N, C, ones=False)
    w_out, w_map = j_ac.fused_attention_mean_padded(
        jnp.asarray(qkv).astype(jnp.bfloat16), jnp.asarray(pol), H,
        real_n=N, compute_dtype=jnp.bfloat16, interpret=True,
    )
    out, fmap = t_ac.fused_attention_mean_padded(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(pol), H, real_n=N
    )
    assert out.dtype == torch.bfloat16 and fmap.dtype == torch.float32
    np.testing.assert_allclose(to_np(out), to_np(w_out), atol=1e-2)
    np.testing.assert_allclose(to_np(fmap), to_np(w_map), atol=1e-2)


# --- K4 and K5: fused_attention_core(_padded) ----------------------------------

def _bf16_ulp_of_max(x):
    return 2.0 ** -8 * float(np.abs(x).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ones", [True, False])
def test_core_plain_matches_jax_kernel(rng, dtype, ones):
    """Mirrors tests/test_kernels.py::test_fused_attention_core_matches_jax,
    kernel to kernel: the normalized map within 1e-6 with the same kept
    entries; out within 1e-5 (fp32) or one bf16 ulp of max|out| (bf16:
    probs @ v sums its fp32 products in another order, then rounds)."""
    B, N, C, H = 4, 17, 24, 2
    qkv, pol = _qkv_policy(rng, B, N, C, ones)
    w_out, w_map = j_ac.fused_attention_core(
        jnp.asarray(qkv).astype(dtype), None if ones else jnp.asarray(pol), H,
        ones_policy=ones, compute_dtype=getattr(jnp, dtype), interpret=True,
    )
    out, fmap = t_ac.fused_attention_core(
        torch.from_numpy(qkv).to(getattr(torch, dtype)),
        None if ones else torch.from_numpy(pol), H, ones_policy=ones,
    )
    assert out.dtype == getattr(torch, dtype) and fmap.dtype == torch.float32
    w_map = to_np(w_map)
    np.testing.assert_array_equal(to_np(fmap) > 0, w_map > 0)
    np.testing.assert_allclose(to_np(fmap), w_map, atol=1e-6)
    np.testing.assert_allclose(to_np(fmap).sum(-1), 1.0, atol=1e-6)
    tol = 1e-5 if dtype == "float32" else _bf16_ulp_of_max(to_np(w_out))
    np.testing.assert_allclose(to_np(out), to_np(w_out), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_padded_plain_matches_jax_kernel(rng, dtype):
    """K5 at NP=32 over 17 real tokens: the JAX kernel's map within 1e-6,
    every pad row and column exactly 0 in both (the JAX code blends the
    identity only on the real diagonal), and the real block equal to K4's
    on the unpadded operands."""
    B, N, NP, C, H = 4, 17, 32, 24, 2
    qkv, pol = _qkv_policy(rng, B, N, C, ones=False)
    qkv_pad = np.pad(qkv, ((0, 0), (0, NP - N), (0, 0)))
    pol_pad = np.pad(pol, ((0, 0), (0, NP - N)))
    w_out, w_map = j_ac.fused_attention_core_padded(
        jnp.asarray(qkv_pad).astype(dtype), jnp.asarray(pol_pad), H, N,
        compute_dtype=getattr(jnp, dtype), interpret=True,
    )
    td = getattr(torch, dtype)
    out, fmap = t_ac.fused_attention_core_padded(
        torch.from_numpy(qkv_pad).to(td), torch.from_numpy(pol_pad), H, N
    )
    got, want = to_np(fmap), to_np(w_map)
    np.testing.assert_allclose(got, want, atol=1e-6)
    for m in (got, want):
        assert np.abs(m[:, N:]).max() == 0.0 and np.abs(m[:, :, N:]).max() == 0.0
    tol = 1e-5 if dtype == "float32" else _bf16_ulp_of_max(to_np(w_out))
    np.testing.assert_allclose(to_np(out)[:, :N], to_np(w_out)[:, :N], atol=tol)
    out4, map4 = t_ac.fused_attention_core(
        torch.from_numpy(qkv).to(td), torch.from_numpy(pol), H
    )
    assert torch.equal(map4, fmap[:, :N, :N])
    assert torch.equal(out4, out[:, :N])


def test_core_plain_is_the_plain_normalize_of_k3s_map(rng):
    """The two-phase design: K4 = K3's raw map, then normalize_attention_map
    (exact) of it."""
    B, N, C, H = 3, 24, 16, 2
    qkv, pol = _qkv_policy(rng, B, N, C, ones=False)
    qkv, pol = torch.from_numpy(qkv), torch.from_numpy(pol)
    out, fmap = t_ac.fused_attention_core(qkv, pol, H, 0.8, 0.3)
    k3_out, raw = t_ac.fused_attention_mean_padded(qkv, pol, H, N)
    assert torch.equal(out, k3_out)
    want = t_roll.normalize_attention_map(raw, 0.8, 0.3, exact_discard=True)
    np.testing.assert_allclose(to_np(fmap), to_np(want), atol=1e-6)


def test_bench_kernels_cli_times_the_three_paths_on_cpu(capsys):
    from protopformer_tpu_torch.cli import bench_kernels

    t_kernels.reset_launch_counts()
    assert bench_kernels.main(["--device", "cpu", "--batch", "1",
                               "--iters", "1", "--warmup", "0"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cpu" and (res["n"], res["np"]) == (197, 256)
    assert set(res["ms_per_block"]) == {
        "plain", "fused_attention_core", "fused_attention_core_padded"}
    # the CPU runs the plain versions: no kernel launched
    assert sum(t_kernels.launch_counts().values()) == 0
