"""Numeric ops of the PyTorch port against the JAX package's ops.

Each case makes its inputs from a seed with numpy and feeds the same arrays
to the JAX function and to its port (CPU tensors). Tolerances: 1e-6 in
fp32; 1e-2 where bf16 rounds (the bf16 ``eps_softmax`` branch and the bf16
``l2_distances`` cross term); every discard threshold bit-equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.ops import activations as j_act
from protopformer_tpu.ops import distances as j_dist
from protopformer_tpu.ops import masking as j_mask
from protopformer_tpu.ops import rollout as j_roll
from protopformer_tpu.ops import tokens as j_tok
from protopformer_tpu_torch.ops import activations as t_act
from protopformer_tpu_torch.ops import distances as t_dist
from protopformer_tpu_torch.ops import masking as t_mask
from protopformer_tpu_torch.ops import rollout as t_roll
from protopformer_tpu_torch.ops import tokens as t_tok
from tests.torch_port import to_np


def _prob_maps(rng, B, M, N):
    """Softmax-like non-negative maps (rows sum to 1), tie-free."""
    maps = rng.uniform(size=(B, M, N)).astype(np.float32) + 1e-3
    return maps / maps.sum(-1, keepdims=True)


# --- masking -----------------------------------------------------------------

def test_softmax_with_policy_matches_jax(rng):
    B, H, N = 2, 3, 17
    logits = rng.normal(size=(B, H, N, N)).astype(np.float32)
    keep = (rng.uniform(size=(B, N)) > 0.4).astype(np.float32)
    keep[:, 0] = 1.0
    want = j_mask.softmax_with_policy(jnp.asarray(logits), jnp.asarray(keep))
    got = t_mask.softmax_with_policy(torch.from_numpy(logits),
                                     torch.from_numpy(keep))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_eps_softmax_matches_jax(rng, dtype, atol):
    logits = rng.normal(size=(2, 3, 17, 17)).astype(np.float32)
    want = j_mask.eps_softmax(jnp.asarray(logits).astype(dtype))
    got = t_mask.eps_softmax(torch.from_numpy(logits).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol)


# --- activations -------------------------------------------------------------

@pytest.mark.parametrize("name", ["erf_as", "gelu_exact", "gelu_speed"])
def test_activation_matches_jax(rng, name):
    x = (rng.normal(size=(4, 33)) * 3).astype(np.float32)
    want = getattr(j_act, name)(jnp.asarray(x))
    got = getattr(t_act, name)(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)


# --- tokens ------------------------------------------------------------------

def test_topk_gather_and_policy_match_jax(rng):
    B, N, C, k = 3, 16, 8, 9
    scores = rng.permutation(B * N).reshape(B, N).astype(np.float32)  # no ties
    tokens = rng.normal(size=(B, N, C)).astype(np.float32)
    want_idx = np.asarray(j_tok.topk_sorted_indices(jnp.asarray(scores), k))
    got_idx = t_tok.topk_sorted_indices(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(
        t_tok.gather_tokens(torch.from_numpy(tokens), got_idx).numpy(),
        np.asarray(j_tok.gather_tokens(jnp.asarray(tokens),
                                       jnp.asarray(want_idx))),
    )
    want_pol, want_pidx = j_tok.reserve_policy(jnp.asarray(scores), k, N + 1)
    got_pol, got_pidx = t_tok.reserve_policy(torch.from_numpy(scores), k, N + 1)
    np.testing.assert_array_equal(got_pol.numpy(), np.asarray(want_pol))
    np.testing.assert_array_equal(got_pidx.numpy(), np.asarray(want_pidx))


# --- distances ---------------------------------------------------------------

@pytest.mark.parametrize("speed,atol", [(False, 1e-6), (True, 1e-2)])
def test_l2_distances_and_activations_match_jax(rng, speed, atol):
    # sigmoid-range tokens and U(0,1) prototypes, as on the model path. The
    # |x|^2 - 2x.p + |p|^2 expansion sums in another order in each
    # framework, so fp32 also allows 1e-6 relative (terms up to ~4)
    tokens = rng.uniform(size=(2, 9, 16)).astype(np.float32) * 0.5
    protos = rng.uniform(size=(40, 16)).astype(np.float32) * 0.5
    want = j_dist.prototype_activations(
        jnp.asarray(tokens), jnp.asarray(protos), speed=speed
    )
    got = t_dist.prototype_activations(
        torch.from_numpy(tokens), torch.from_numpy(protos), speed=speed
    )
    # (pooled activations, distances, activation maps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), atol=atol, rtol=1e-6)


def test_log_similarity_and_linear_match_jax(rng):
    d = rng.uniform(size=(3, 7)).astype(np.float32) * 5
    for fn in ("log", "linear"):
        np.testing.assert_allclose(
            to_np(t_dist.distance_to_similarity(torch.from_numpy(d), fn)),
            to_np(j_dist.distance_to_similarity(jnp.asarray(d), fn)),
            atol=1e-6,
        )


# --- rollout -----------------------------------------------------------------

def test_fuse_heads_and_static_bracket_match_jax(rng):
    attn = rng.uniform(size=(2, 3, 5, 5)).astype(np.float32)
    for mode in ("mean", "max", "min"):
        np.testing.assert_allclose(
            to_np(t_roll._fuse_heads(torch.from_numpy(attn), mode)),
            to_np(j_roll._fuse_heads(jnp.asarray(attn), mode)), atol=1e-7,
        )
    to_bits = t_roll._f32_bits
    for bound in (1.0, (1e-5, 0.37)):
        assert (t_roll._static_bracket(bound, to_bits)
                == j_roll._static_bracket(bound, to_bits))


@pytest.mark.parametrize("fn,bound", [
    ("kth_largest", None),
    ("kth_largest", 1.0),
    ("kth_largest", (1e-6, 0.5)),
    ("kth_largest_prefix16", None),
    ("kth_largest_prefix16", 1.0),
    ("kth_largest_bf16", None),
    ("kth_largest_bf16", 1.0),
])
def test_kth_largest_bit_equal(rng, fn, bound):
    flat = _prob_maps(rng, 4, 24, 24).reshape(4, -1)
    keep = flat.shape[1] - int(flat.shape[1] * 0.9)
    j_in, t_in = jnp.asarray(flat), torch.from_numpy(flat)
    if fn == "kth_largest_bf16":
        j_in, t_in = j_in.astype(jnp.bfloat16), t_in.bfloat16()
    want = getattr(j_roll, fn)(j_in, keep, bound=bound)
    got = getattr(t_roll, fn)(t_in, keep, bound=bound)
    np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("case", [
    dict(exact=True),
    dict(exact=False),
    dict(exact=False, bf16=True),
    dict(exact=True, value_bound=1.0, stochastic_eps=1e-6),
    dict(exact=False, bf16=True, value_bound=1.0, stochastic_eps=1e-6),
    dict(exact=True, keep_elements=17 * 17),
    dict(exact=False, bf16=True, sample=4),
    dict(exact=False, sample=4, value_bound=1.0, stochastic_eps=1e-6),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_masked_map_stats_matches_jax(rng, case):
    case = dict(case)
    exact = case.pop("exact")
    bf16 = case.pop("bf16", False)
    N = 24
    maps = _prob_maps(rng, 4, N, N)
    if "keep_elements" in case:  # a real 17x17 map zero-padded to 24x24
        maps[:, 17:] = 0.0
        maps[:, :, 17:] = 0.0
    j_in, t_in = jnp.asarray(maps), torch.from_numpy(maps)
    if bf16:
        j_in, t_in = j_in.astype(jnp.bfloat16), t_in.bfloat16()
    want_t, want_s = j_roll.masked_map_stats(j_in, 0.9, exact, **case)
    got_t, got_s = t_roll.masked_map_stats(t_in, 0.9, exact, **case)
    assert got_t.dtype == (torch.bfloat16 if bf16 and not exact
                           else torch.float32)
    np.testing.assert_array_equal(to_np(got_t), to_np(want_t))
    np.testing.assert_allclose(to_np(got_s), to_np(want_s), atol=1e-6)


def test_masked_map_stats_no_discard_sentinel(rng):
    maps = _prob_maps(rng, 2, 8, 8)
    got_t, got_s = t_roll.masked_map_stats(torch.from_numpy(maps), 0.0)
    want_t, want_s = j_roll.masked_map_stats(jnp.asarray(maps), 0.0)
    np.testing.assert_array_equal(to_np(got_t), to_np(want_t))
    np.testing.assert_allclose(to_np(got_s), to_np(want_s), atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_rollout_row_scores_lazy_matches_jax(rng, bf16):
    B, N, L = 2, 17, 3
    maps = [_prob_maps(rng, B, N, N) for _ in range(L)]
    seed = np.zeros((B, 1, N), np.float32)
    seed[:, 0, 0] = 1.0
    j_maps = [jnp.asarray(m) for m in maps]
    t_maps = [torch.from_numpy(m) for m in maps]
    if bf16:
        j_maps = [m.astype(jnp.bfloat16) for m in j_maps]
        t_maps = [m.bfloat16() for m in t_maps]
    j_stats = [j_roll.masked_map_stats(m, 0.9, not bf16) for m in j_maps]
    t_stats = [t_roll.masked_map_stats(m, 0.9, not bf16) for m in t_maps]
    want = j_roll.rollout_row_scores_lazy(
        j_maps, [t for t, _ in j_stats], [s for _, s in j_stats],
        jnp.asarray(seed), 0.2,
    )
    got = t_roll.rollout_row_scores_lazy(
        t_maps, [t for t, _ in t_stats], [s for _, s in t_stats],
        torch.from_numpy(seed), 0.2,
    )
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)


# --- eager rollout -----------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False], ids=["exact", "prefix16"])
@pytest.mark.parametrize("M", [24, 1], ids=["self", "class-row"])
def test_normalize_attention_map_matches_jax(rng, exact, M):
    maps = _prob_maps(rng, 3, M, 24)
    want = j_roll.normalize_attention_map(jnp.asarray(maps), 0.9, 0.2, exact)
    got = t_roll.normalize_attention_map(torch.from_numpy(maps), 0.9, 0.2, exact)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got) > 0, to_np(want) > 0)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)


def test_normalize_attention_map_signed_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        t_roll.normalize_attention_map(torch.zeros((1, 4, 4)), signed=True)


def _attn_stack(rng, L, B, H, N):
    """(L, B, H, N, N) softmax-like per-head probabilities."""
    return _prob_maps(rng, L * B * H, N, N).reshape(L, B, H, N, N)


def test_rollout_step_and_attn_rollout_match_jax(rng):
    L, B, H, N = 3, 2, 2, 17
    attn = _attn_stack(rng, L, B, H, N)
    init = t_roll.identity_rollout(B, N)
    np.testing.assert_array_equal(to_np(init), to_np(j_roll.identity_rollout(B, N)))
    want = j_roll.rollout_step(j_roll.identity_rollout(B, N), jnp.asarray(attn[0]))
    got = t_roll.rollout_step(init, torch.from_numpy(attn[0]))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)
    want = j_roll.attn_rollout(jnp.asarray(attn), 0.8, "mean", 0.3)
    got = t_roll.attn_rollout(torch.from_numpy(attn), 0.8, "mean", 0.3)
    assert got.shape == (B, N, N) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5)


def test_rollout_row_scores_matches_jax_and_the_full_product(rng):
    B, N, L = 2, 17, 3
    norm = [to_np(t_roll.normalize_attention_map(
        torch.from_numpy(_prob_maps(rng, B, N, N)))) for _ in range(L)]
    seed = np.zeros((B, 1, N), np.float32)
    seed[:, 0, 0] = 1.0
    want = j_roll.rollout_row_scores([jnp.asarray(m) for m in norm],
                                     jnp.asarray(seed))
    got = t_roll.rollout_row_scores([torch.from_numpy(m) for m in norm],
                                    torch.from_numpy(seed))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)
    full = norm[2] @ norm[1] @ norm[0]
    np.testing.assert_allclose(to_np(got)[:, 0], full[:, 0], atol=1e-6)
