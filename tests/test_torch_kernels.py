"""K1-K3 of the PyTorch port against the JAX package's Pallas kernels.

On the CPU each public kernel function runs its plain PyTorch version; the
JAX kernels run in interpret mode, as tests/test_kernels.py runs them.
The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_gpu.py.
"""

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
