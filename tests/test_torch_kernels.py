"""K1-K5 of the PyTorch port against the JAX package's Pallas kernels.

On the CPU each public kernel function runs its plain PyTorch version; the
JAX kernels run in interpret mode, as tests/test_kernels.py runs them.
The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_gpu.py.
"""

import json
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.kernels import attention_core as j_ac
from protopformer_tpu.kernels import stats as j_stats
from protopformer_tpu.ops import rollout as j_roll
from protopformer_tpu_torch import kernels as t_kernels
from protopformer_tpu_torch.kernels import _build
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


_RADIX_CASES = ("fp32", "bf16", "ties", "all_equal", "keep_1", "keep_E-1",
                "ones", "above_hi", "zeros")


def _radix_case(case, rng):
    """(B, E) non-negative fp32 maps and the keep count of one case."""
    B, N = 3, 24
    E = N * N
    maps = _prob_maps(rng, B, N).reshape(B, E)
    keep = E - int(E * 0.9)
    if case == "bf16":
        maps = to_np(torch.from_numpy(maps).bfloat16())
    elif case == "ties":  # the keep-th value repeated across the boundary
        order = np.argsort(-maps, axis=1)
        for b in range(B):
            maps[b, order[b, keep - 4:keep + 4]] = maps[b, order[b, keep - 1]]
    elif case == "all_equal":
        maps[:] = 1.0 / N
    elif case == "keep_1":
        keep = 1
    elif case == "keep_E-1":
        keep = E - 1
    elif case == "ones":  # the keep-th largest is exactly 1.0, hi0 itself
        maps[:, :keep + 10] = 1.0
    elif case == "above_hi":  # the keep-th largest is above 1.0: clamped
        maps[:, :keep + 10] = rng.uniform(1.0, 4.0, size=(B, keep + 10))
    elif case == "zeros":  # fewer than keep entries are non-zero
        maps[:, keep // 2:] = 0.0
    return np.ascontiguousarray(maps, dtype=np.float32), keep


@pytest.mark.parametrize("prefix16", [False, True], ids=["fp32_keys", "prefix16"])
@pytest.mark.parametrize("case", _RADIX_CASES)
def test_radix_select_matches_jax_and_the_bisection(rng, case, prefix16):
    """K1's threshold: the radix select of the keep-th largest key, clamped
    to [0, bits(1.0)], is bit-equal to the JAX package's bisections over
    that bracket (kth_largest / kth_largest_prefix16 with bound=1.0) and to
    the port's bisect_threshold as K1's plain version runs it; unclamped,
    to the JAX bisections from [0, max]."""
    maps, keep = _radix_case(case, rng)
    keys = t_stats.bisect_keys(torch.from_numpy(maps), prefix16)
    bits, hi0 = (16, 0x3F80) if prefix16 else (32, 0x3F800000)
    j_fn = j_roll.kth_largest_prefix16 if prefix16 else j_roll.kth_largest

    def jax_key(bound):
        key = to_np(j_fn(jnp.asarray(maps), keep, bound=bound)).view(np.int32)
        return key >> 16 if prefix16 else key

    got = t_stats.radix_select_keys(keys, keep, bits, 8, hi0)
    np.testing.assert_array_equal(to_np(got), jax_key(1.0))
    lo = torch.zeros(keys.shape[0], dtype=torch.int32)
    bisected = t_roll.bisect_threshold(keys, keep, lo, torch.full_like(lo, hi0),
                                       15 if prefix16 else 31)
    assert torch.equal(got, bisected)
    full = t_stats.radix_select_keys(keys, keep, bits, 8, (1 << bits) - 1)
    np.testing.assert_array_equal(to_np(full), jax_key(None))
    if case == "above_hi":
        assert bool((got == hi0).all()) and bool((full > hi0).all())


def _negative_zero_maps(rng, B=3, N=24):
    """(B, N, N) probability maps holding -0.0 entries: a row of them in
    every map, every 7th entry of map 1, and all but keep - 3 entries of
    map 2, whose threshold is then 0."""
    maps = _prob_maps(rng, B, N)
    E = N * N
    keep = E - int(E * 0.9)
    maps[:, 5, :] = -0.0
    maps[1].reshape(-1)[::7] = -0.0
    maps[2].reshape(-1)[keep - 3:] = -0.0
    return maps, keep


@pytest.mark.parametrize("exact,dtype", [(True, "float32"),
                                         (False, "float32"),
                                         (False, "bfloat16")],
                         ids=["exact", "prefix16", "prefix16_bf16"])
def test_select_counts_negative_zero_as_zero(rng, exact, dtype):
    """A -0.0 entry is a zero: the JAX kernels bisect signed keys and never
    count it, so the radix select (K1, K2, K4/K5's normalize) maps a key
    whose sign bit is set to 0. Held bit for bit against JAX's
    masked_map_stats and the port's bisect_threshold on the signed keys in
    both modes, and against the JAX kernel (interpret mode) in exact mode.
    In prefix16 mode the JAX kernel shifts the keys logically
    (kernels/stats.py:44), which makes -0.0 the largest 16-bit key; the
    port follows masked_map_stats, the contract that kernel names."""
    maps, keep = _negative_zero_maps(rng)
    t_in = torch.from_numpy(maps).to(getattr(torch, dtype))
    j_in = jnp.asarray(maps).astype(dtype)
    got_t, got_s = t_stats.fused_map_stats(t_in, 0.9, exact_discard=exact)
    want_t, want_s = j_roll.masked_map_stats(j_in, 0.9, exact_discard=exact)
    bits = lambda t: to_np(t.float() if isinstance(t, torch.Tensor)
                           else t.astype(jnp.float32)).view(np.int32)
    np.testing.assert_array_equal(bits(got_t), bits(want_t))
    np.testing.assert_allclose(to_np(got_s), to_np(want_s), atol=1e-6)
    assert float(got_t.float()[2]) == 0.0 and float(got_t.float()[0]) > 0.0
    if exact:
        k_t, k_s = j_stats.fused_map_stats(j_in, 0.9, exact_discard=True,
                                           interpret=True)
        np.testing.assert_array_equal(bits(got_t), bits(k_t))
        np.testing.assert_allclose(to_np(got_s), to_np(k_s), atol=1e-6)

    a = t_in.float()
    key_bits = 32 if exact else 16
    selected = t_stats.radix_select_keys(t_stats.bisect_keys(a, not exact),
                                         keep, key_bits, 8, (1 << key_bits) - 1)
    # the signed keys of the JAX bisections: an arithmetic shift keeps
    # -0.0 negative
    signed = a.reshape(3, -1).view(torch.int32) >> (32 - key_bits)
    lo = torch.zeros(3, dtype=torch.int32)
    bisected = t_roll.bisect_threshold(signed, keep, lo, signed.amax(dim=1),
                                       key_bits - 1)
    assert torch.equal(selected, bisected)


def _signed_case_maps(rng, case, B=3, N=24):
    """(B, N, N) fp32 maps of one signed-select case (CaiT's talking-heads
    maps may be all negative, mixed or all positive) and their keep at a
    0.9 discard. "zeros": -0.0 and +0.0 entries around the threshold;
    "ties": five values repeated; "on_negative_zero": keep - 1 positive
    entries above -0.0 ones (map 0), keep - 3 above two +0.0 and then -0.0
    ones (map 1), so that t is -0.0, and keep - 1 above +0.0 ones (map 2),
    so that t is +0.0."""
    E = N * N
    keep = E - int(E * 0.9)
    x = rng.normal(size=(B, N, N)).astype(np.float32)
    flat = x.reshape(B, -1)
    if case == "negative":
        x = -np.abs(x) - 1e-3
    elif case == "positive":
        x = np.abs(x) + 1e-3
    elif case == "zeros":
        flat[:, ::3] = -0.0
        flat[:, 1::5] = 0.0
    elif case == "ties":
        x = rng.choice(np.float32([-0.5, -0.25, 0.0, 0.25, 0.5]),
                       size=(B, N, N))
    elif case == "on_negative_zero":
        x = -np.abs(x) - 1e-3
        flat = x.reshape(B, -1)
        flat[:, :keep - 1] = np.abs(flat[:, :keep - 1]) + 1e-3
        flat[:, keep - 1:keep + 6] = -0.0
        flat[1, keep - 3:keep - 1] = 0.0
        flat[2, keep - 1:keep + 2] = 0.0
        x = np.stack([m.reshape(-1)[rng.permutation(E)].reshape(N, N)
                      for m in x])
    return x, keep


_SIGNED_CASES = ["negative", "mixed", "positive", "zeros", "ties",
                 "on_negative_zero"]


@pytest.mark.parametrize("mode", ["bf16_speed", "bf16_exact", "fp32"])
@pytest.mark.parametrize("case", _SIGNED_CASES)
def test_signed_radix_select_equals_the_signed_bisection(rng, case, mode):
    """The signed kernel's algorithm (``signed_map_stats_plain``: the radix
    select on ``signed_keys``' monotone keys, 16 bits of a bf16 map's in
    speed mode, else 32, and their inverse) gives the bisection chain's
    thresholds bit for bit (``kth_largest_bf16_signed`` /
    ``kth_largest_signed``, and ``masked_map_stats(signed=True)``, whose
    row sums it gives exactly on the CPU), and JAX's."""
    maps, keep = _signed_case_maps(rng, case)
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    t_in = torch.from_numpy(maps).to(dtype)
    key16 = mode == "bf16_speed"
    t, s = t_stats.signed_map_stats_plain(t_in, keep, key16)
    kth = (t_roll.kth_largest_bf16_signed(t_in.reshape(3, -1), keep) if key16
           else t_roll.kth_largest_signed(t_in.reshape(3, -1), keep))
    bits = lambda x: to_np(x.float()).view(np.int32)
    np.testing.assert_array_equal(bits(t), bits(kth))
    want_t, want_s = t_roll.masked_map_stats(t_in, 0.9, not key16,
                                             signed=True)
    np.testing.assert_array_equal(bits(t), bits(want_t))
    np.testing.assert_array_equal(to_np(s), to_np(want_s))
    jt, _ = j_roll.masked_map_stats(
        jnp.asarray(maps).astype("float32" if mode == "fp32" else "bfloat16"),
        0.9, not key16, signed=True)
    np.testing.assert_array_equal(bits(t), to_np(jt.astype(jnp.float32)
                                                   ).view(np.int32))
    if case == "on_negative_zero":
        assert bits(t).tolist() == [-2**31, -2**31, 0]  # -0.0, -0.0, +0.0
    if case == "negative":
        assert bool((t < 0).all())
    # the key's top bit marks a clear sign bit, and the inverse undoes it
    keys = t_stats.signed_keys(t_in.float(), key16)
    top = 1 << (15 if key16 else 31)
    sign_clear = t_in.float().reshape(3, -1).view(torch.int32) >= 0
    assert torch.equal(keys & top != 0, sign_clear)
    np.testing.assert_array_equal(
        bits(t_stats.threshold_from_signed_key(keys[:, 7], key16)),
        bits(t_in.float().reshape(3, -1)[:, 7]))


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


# --- the kernel library's C interface -------------------------------------------

# entry points that once let a caller choose a launch's route; each
# launcher now takes its route from its operands' shape alone
_FORCING_ENTRIES = (
    "ppf_map_stats_on_route", "ppf_map_stats_route_active_clusters",
    "ppf_attention_core_normalize", "ppf_attention_core_route_active_clusters",
    "ppf_attention_mean_bf16_global")


def _extern_c_definitions():
    """{name: [parameter names]} of every ``extern "C"`` function the
    sources define (declarations of another source's functions left out)."""
    defined = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C"\s+[\w\s*]+?\b(\w+)\s*\(([^)]*)\)\s*\{',
                             path.read_text()):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            defined[m.group(1)] = [re.findall(r"\w+", p)[-1] for p in params]
    return defined


def test_every_signature_is_an_exported_symbol():
    """Each symbol ``_build`` binds is an ``extern "C"`` function of
    ``csrc/*.cu`` with as many parameters as its argtypes, and no exported
    function takes a route or a ``global`` flag from its caller."""
    defined = _extern_c_definitions()
    assert set(_build._SIGNATURES) <= set(defined), (
        set(_build._SIGNATURES) - set(defined))
    assert _build._LONG_RESULTS <= set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert len(argtypes) == len(defined[name]), name
    for name, params in defined.items():
        assert not {"route", "global"} & set(params), name


@pytest.mark.parametrize("name", _FORCING_ENTRIES)
def test_no_forcing_entry_is_left(name):
    """A route-forcing entry is neither defined nor bound, and no source of
    the port names it."""
    assert name not in _extern_c_definitions()
    assert name not in _build._SIGNATURES
    package = _build.CSRC.parent
    for path in [*package.rglob("*.py"), *_build.CSRC.glob("*.cu*")]:
        assert name not in path.read_text(), path
