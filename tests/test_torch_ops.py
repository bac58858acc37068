"""Numeric ops of the PyTorch port against the JAX package's ops.

Each case makes its inputs from a seed with numpy and feeds the same arrays
to the JAX function and to its port (CPU tensors). Tolerances: 1e-6 in
fp32; 1e-2 where bf16 rounds (the bf16 ``eps_softmax`` branch and the bf16
``l2_distances`` cross term); every discard threshold bit-equal.
``gelu_speed``'s routes (the one-pass kernel or the plain chain) are
followed on a CPU tensor that says it lies on the card, with a recording
launcher in place of the kernel library.
"""

import contextlib
import dataclasses
import inspect

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
from protopformer_tpu_torch.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu_torch.kernels import _build
from protopformer_tpu_torch.kernels.activation import gelu_tanh_cuda
from protopformer_tpu_torch.models.layers import Mlp
from protopformer_tpu_torch.utils import profiling
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


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_class_attn_softmax_with_policy_matches_jax(rng, dtype, atol):
    B, H, N = 2, 3, 17
    logits = rng.normal(size=(B, H, 1, N)).astype(np.float32)
    keep = (rng.uniform(size=(B, N)) > 0.4).astype(np.float32)
    keep[:, 0] = 1.0
    want = j_mask.class_attn_softmax_with_policy(
        jnp.asarray(logits).astype(dtype), jnp.asarray(keep))
    got = t_mask.class_attn_softmax_with_policy(
        torch.from_numpy(logits).to(getattr(torch, dtype)),
        torch.from_numpy(keep))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol)


# --- activations -------------------------------------------------------------

@pytest.mark.parametrize("name", ["erf_as", "gelu_exact", "gelu_speed"])
def test_activation_matches_jax(rng, name):
    x = (rng.normal(size=(4, 33)) * 3).astype(np.float32)
    want = getattr(j_act, name)(jnp.asarray(x))
    got = getattr(t_act, name)(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, to follow
    ``gelu_speed``'s routes where there is none."""

    @property
    def is_cuda(self):
        return True


class _GeluLibrary:
    """The kernel library's GELU launcher, recording the counts it gets."""

    def __init__(self):
        self.calls = []

    def ppf_gelu_tanh_bf16(self, x, y, n, stream):
        self.calls.append(n)
        return 0


@pytest.fixture
def gelu_library(monkeypatch):
    """A fresh counter registry and the recording launcher in place of the
    built library (no launch, no stream)."""
    lib = _GeluLibrary()
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: contextlib.nullcontext(0))
    return lib


@pytest.mark.parametrize("on_card,dtype,requires_grad,grad_mode,route", [
    (False, torch.bfloat16, False, True, "cpu"),
    (False, torch.bfloat16, True, True, "cpu"),
    (False, torch.float32, False, True, "cpu"),
    (True, torch.bfloat16, False, True, "pass"),
    (True, torch.bfloat16, True, False, "pass"),
    (True, torch.bfloat16, True, True, "plain"),
    (True, torch.float32, False, True, "plain"),
    (True, torch.float16, False, True, "plain"),
], ids=["cpu_bf16", "cpu_bf16_grad", "cpu_fp32", "card_bf16",
        "card_bf16_no_grad_mode", "card_bf16_autograd", "card_fp32",
        "card_fp16"])
def test_gelu_speed_routes_by_what_the_tensor_shows(
        rng, gelu_library, on_card, dtype, requires_grad, grad_mode, route):
    """The pass for a bf16 tensor on the card that needs no gradient, one
    launch counted ``launches.gelu_tanh``; else the plain chain, its
    outputs (and gradient) unchanged, counted ``gelu.plain`` on the card
    alone."""
    x = torch.from_numpy((rng.normal(size=(4, 33)) * 3).astype(np.float32)
                         ).to(dtype)
    want = t_act.gelu_speed_plain(x)
    if on_card:
        x = x.as_subclass(_OnCard)
    x.requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad_mode):
        got = t_act.gelu_speed(x)
    assert profiling.counts() == {
        "pass": {"launches.gelu_tanh": 1}, "plain": {"gelu.plain": 1},
        "cpu": {}}[route]
    assert gelu_library.calls == ([x.numel()] if route == "pass" else [])
    assert got.shape == x.shape and got.dtype == dtype
    if route != "pass":
        assert torch.equal(got.detach().view(torch.uint8),
                           want.view(torch.uint8))
    if requires_grad and grad_mode:
        got.float().sum().backward()
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_gelu_speed_hands_the_pass_a_contiguous_tensor(rng, gelu_library):
    x = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32)).to(
        torch.bfloat16).as_subclass(_OnCard).t()
    assert not x.is_contiguous()
    assert t_act.gelu_speed(x).shape == (5, 6)
    assert gelu_library.calls == [30]


@pytest.mark.parametrize("case,error", [("cpu", ValueError),
                                        ("fp32", TypeError),
                                        ("strided", ValueError)])
def test_gelu_pass_refuses_what_its_kernel_does_not_take(gelu_library, case,
                                                         error):
    x = torch.zeros((4, 16), dtype=torch.bfloat16)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    if case == "fp32":
        x = x.float()
    if case == "strided":
        x = x.t()
    with pytest.raises(error):
        gelu_tanh_cuda(x)
    assert gelu_library.calls == [] and profiling.counts() == {}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_a_bf16_mlp_takes_the_pass_with_no_option(rng, gelu_library,
                                                  training):
    """``Mlp`` in bf16 on the card: the pass once a forward under no_grad,
    the chain under training's autograd; nothing selects the route but the
    tensor (no config field, no argument of ``gelu_speed``)."""
    mlp = Mlp(8, 32, torch.bfloat16).train(training)
    x = torch.from_numpy(rng.normal(size=(2, 5, 8)).astype(np.float32)).to(
        torch.bfloat16).as_subclass(_OnCard)
    with torch.set_grad_enabled(training):
        y = mlp(x)
    assert y.shape == (2, 5, 8)
    assert profiling.counts() == ({"gelu.plain": 1} if training
                                  else {"launches.gelu_tanh": 1})
    assert gelu_library.calls == ([] if training else [2 * 5 * 32])
    assert list(inspect.signature(t_act.gelu_speed).parameters) == ["x"]
    for cfg in (BackboneConfig, PPNetConfig):
        assert not [f.name for f in dataclasses.fields(cfg)
                    if "gelu" in f.name]


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


def _signed_maps(rng, sign, shape):
    """Mixed-sign, all-negative or all-positive maps (CaiT's talking-heads
    maps can be any of these), with a -0.0 and a +0.0 entry."""
    x = rng.normal(size=shape).astype(np.float32)
    x = {"mixed": x, "negative": -np.abs(x), "positive": np.abs(x)}[sign]
    x.reshape(shape[0], -1)[:, :2] = (-0.0, 0.0)
    return x


@pytest.mark.parametrize("sign", ["mixed", "negative", "positive"])
@pytest.mark.parametrize("fn", ["kth_largest_signed",
                                "kth_largest_bf16_signed"])
def test_kth_largest_signed_bit_equal(rng, fn, sign):
    flat = _signed_maps(rng, sign, (4, 999))
    j_in, t_in = jnp.asarray(flat), torch.from_numpy(flat)
    if fn == "kth_largest_bf16_signed":
        j_in, t_in = j_in.astype(jnp.bfloat16), t_in.bfloat16()
    for keep in (1, 10, 100, 999):
        want = getattr(j_roll, fn)(j_in, keep)
        got = getattr(t_roll, fn)(t_in, keep)
        assert got.dtype == t_in.dtype
        np.testing.assert_array_equal(to_np(got).view(np.int32),
                                      to_np(want).view(np.int32))
    with pytest.raises(ValueError, match="non-negative"):
        getattr(t_roll, fn)(t_in, 10, bound=1.0)


def test_monotone_keys_are_the_jax_keys_shifted(rng):
    """The port's int32 keys are JAX's uint32 keys minus 2^31, so the two
    bisections visit the same thresholds; the inverse returns the bits."""
    x = _signed_maps(rng, "mixed", (3, 64))
    x[0, :2] = (np.finfo(np.float32).max, -np.finfo(np.float32).max)
    want = np.asarray(j_roll._monotone_keys_u32(jnp.asarray(x))).astype(np.int64)
    got = t_roll._monotone_keys_i32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want - 2**31)
    np.testing.assert_array_equal(
        t_roll._key_to_f32(got).numpy().view(np.int32), x.view(np.int32))


@pytest.mark.parametrize("case", [
    dict(exact=True),
    dict(exact=False),
    dict(exact=False, sample=8),
    dict(exact=False, bf16=True),
    dict(exact=False, bf16=True, sample=8),
    dict(exact=True, sign="negative"),
    dict(exact=False, bf16=True, sign="negative"),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_masked_map_stats_signed_matches_jax(rng, case):
    case = dict(case)
    exact, bf16 = case.pop("exact"), case.pop("bf16", False)
    maps = _signed_maps(rng, case.pop("sign", "mixed"), (3, 40, 40))
    j_in, t_in = jnp.asarray(maps), torch.from_numpy(maps)
    if bf16:
        j_in, t_in = j_in.astype(jnp.bfloat16), t_in.bfloat16()
    want_t, want_s = j_roll.masked_map_stats(j_in, 0.9, exact, signed=True,
                                             **case)
    got_t, got_s = t_roll.masked_map_stats(t_in, 0.9, exact, signed=True,
                                           **case)
    assert got_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(to_np(got_t).view(np.int32),
                                  to_np(want_t).view(np.int32))
    np.testing.assert_allclose(to_np(got_s), to_np(want_s), atol=1e-6)


def test_masked_map_stats_signed_all_negative_keeps_the_top_tenth(rng):
    """tests/test_ops.py's all-negative case: the least-negative tenth is
    kept, as the reference's topk-scatter keeps it."""
    x = -np.abs(rng.normal(size=(2, 196, 196))).astype(np.float32)
    t, s = t_roll.masked_map_stats(torch.from_numpy(x), 0.9, True,
                                   signed=True)
    want_t, want_s = j_roll.masked_map_stats(jnp.asarray(x), 0.9, True,
                                             signed=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-6)
    ref = torch.from_numpy(x.copy())
    flat = ref.view(2, -1)
    _, idx = flat.topk(int(flat.shape[-1] * 0.9), -1, False)
    flat.scatter_(1, idx, 0)
    np.testing.assert_allclose(s.numpy(), ref.sum(-1).numpy(), atol=1e-5)
    assert (t.numpy() < 0).all()


@pytest.mark.parametrize("bound", [dict(value_bound=1.0),
                                   dict(stochastic_eps=1e-6)],
                         ids=["value_bound", "stochastic_eps"])
def test_masked_map_stats_signed_rejects_probability_bounds(bound):
    with pytest.raises(ValueError, match="not probabilities"):
        t_roll.masked_map_stats(torch.zeros((1, 4, 4)), 0.9, signed=True,
                                **bound)



class _SignedLibrary:
    """The kernel library's signed select launcher, recording its calls."""

    def __init__(self):
        self.calls = []

    def ppf_signed_map_stats(self, fmap, map_is_bf16, B, N, keep, prefix16,
                             t, s, stream):
        self.calls.append({"bf16": map_is_bf16, "B": B, "N": N, "keep": keep,
                           "key16": prefix16})
        return 0


@pytest.fixture
def signed_library(monkeypatch):
    """A fresh counter registry and the recording launcher in place of the
    built library (no launch, no stream)."""
    lib = _SignedLibrary()
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: contextlib.nullcontext(0))
    return lib


@pytest.mark.parametrize("on_card,dtype,exact,kw,route", [
    (False, torch.bfloat16, False, {}, "cpu"),
    (False, torch.float32, True, {}, "cpu"),
    (True, torch.bfloat16, False, {}, "kernel"),
    (True, torch.bfloat16, True, {}, "kernel"),
    (True, torch.float32, True, {}, "kernel"),
    (True, torch.float32, False, {}, "kernel"),
    (True, torch.bfloat16, False, {"sample": 2}, "plain"),
    (True, torch.float32, True, {"keep_elements": 1500}, "plain"),
    (True, torch.float32, True, {"rows": 39}, "plain"),
    (True, torch.float16, True, {}, "plain"),
    (True, torch.bfloat16, False, {"signed": False}, "unsigned"),
], ids=["cpu_bf16_speed", "cpu_fp32", "card_bf16_speed", "card_bf16_exact",
        "card_fp32", "card_fp32_speed", "card_sampled", "card_padded",
        "card_not_square", "card_fp16", "card_unsigned"])
def test_signed_search_routes_by_what_the_map_shows(
        rng, signed_library, on_card, dtype, exact, kw, route):
    """The hand-written signed select for a whole square fp32 or bf16 map
    on the card (16-bit keys for a bf16 map in speed mode, else 32), one
    launch counted ``launches.signed_map_stats``, t in bf16 only there;
    else the bisection chain, its outputs unchanged, counted
    ``signed_stats.plain`` on the card alone (sampled counts, padded or
    non-square maps, fp16); unsigned searches are not this route's. The
    span's passes follow the route (``signed_search_passes``)."""
    kw = dict(kw)
    rows, signed = kw.pop("rows", 40), kw.pop("signed", True)
    maps = torch.from_numpy(_signed_maps(rng, "mixed", (2, rows, 40))
                            ).to(dtype)
    if not signed:
        maps = maps.abs()
    want = t_roll.masked_map_stats(maps, 0.9, exact, signed=signed, **kw)
    fmap = maps.as_subclass(_OnCard) if on_card else maps
    t, s = t_roll.masked_map_stats(fmap, 0.9, exact, signed=signed, **kw)
    assert profiling.counts() == {
        "kernel": {"launches.signed_map_stats": 1},
        "plain": {"signed_stats.plain": 1}, "cpu": {}, "unsigned": {}}[route]
    key16 = dtype == torch.bfloat16 and not exact
    keep = 1600 - int(1600 * 0.9)
    assert signed_library.calls == ([{
        "bf16": int(dtype == torch.bfloat16), "B": 2, "N": 40, "keep": keep,
        "key16": int(key16)}] if route == "kernel" else [])
    assert t.shape == (2,) and s.shape == (2, rows)
    assert s.dtype == torch.float32
    assert t.dtype == (torch.bfloat16 if key16 else torch.float32)
    if route != "kernel":
        assert torch.equal(t.float().view(torch.int32),
                           want[0].float().view(torch.int32))
        assert torch.equal(s, want[1])
    if signed and "keep_elements" not in kw:  # CaiT's maps are unpadded
        passes = {"kernel": 2 if key16 else 4}.get(route, 16 if key16 else 32)
        assert t_roll.signed_search_passes(
            fmap, exact, kw.get("sample", 1)) == passes


def test_the_stacked_signed_search_is_one_launch(rng, signed_library):
    """``masked_map_stats_multi`` (``rollout_stats_batched="on"``) hands the
    kernel the stacked maps: one launch over every layer's rows."""
    maps = [torch.from_numpy(_signed_maps(rng, "mixed", (2, 24, 24))).to(
        torch.bfloat16).as_subclass(_OnCard) for _ in range(3)]
    stats = t_roll.masked_map_stats_multi(maps, 0.9, False, signed=True)
    assert [(t.shape, s.shape) for t, s in stats] == [((2,), (2, 24))] * 3
    assert signed_library.calls == [{"bf16": 1, "B": 6, "N": 24,
                                     "keep": 576 - int(576 * 0.9),
                                     "key16": 1}]
    assert profiling.counts() == {"launches.signed_map_stats": 1}


@pytest.mark.parametrize("case,error", [("cpu", ValueError),
                                        ("fp16", TypeError),
                                        ("not_square", ValueError),
                                        ("strided", ValueError),
                                        ("fp32_key16", ValueError)])
def test_signed_select_refuses_what_its_kernel_does_not_take(
        signed_library, case, error):
    from protopformer_tpu_torch.kernels.stats import signed_map_stats_cuda

    fmap = torch.zeros((2, 8, 8), dtype=torch.bfloat16)
    if case != "cpu":
        fmap = fmap.as_subclass(_OnCard)
    fmap = {"fp16": lambda m: m.half(), "not_square": lambda m: m[:, :7],
            "strided": lambda m: m.transpose(1, 2),
            "fp32_key16": lambda m: m.float()}.get(case, lambda m: m)(fmap)
    with pytest.raises(error):
        signed_map_stats_cuda(fmap, 7, True)
    assert signed_library.calls == [] and profiling.counts() == {}


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


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "prefix16"])
def test_normalize_attention_map_signed_matches_jax(rng, exact):
    maps = _signed_maps(rng, "mixed", (3, 24, 24))
    want = j_roll.normalize_attention_map(jnp.asarray(maps), 0.9, 0.2, exact,
                                          signed=True)
    got = t_roll.normalize_attention_map(torch.from_numpy(maps), 0.9, 0.2,
                                         exact, signed=True)
    np.testing.assert_array_equal(to_np(got) != 0, to_np(want) != 0)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)


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


def test_attn_rollout_cait_matches_jax(rng):
    """tests/test_ops.py's CaiT rollout case on the same inputs in both
    frameworks: within 1e-5, rollout rows summing to 1, scores >= 0."""
    L_sa, L_ca, B, H, P = 4, 2, 2, 3, 16
    sa = _prob_maps(rng, L_sa * B * H, P, P).reshape(L_sa, B, H, P, P)
    ca = _prob_maps(rng, L_ca * B * H, 1, P + 1).reshape(L_ca, B, H, 1, P + 1)
    want_roll, want_cls = j_roll.attn_rollout_cait(jnp.asarray(sa),
                                                   jnp.asarray(ca))
    roll, cls = t_roll.attn_rollout_cait(torch.from_numpy(sa),
                                         torch.from_numpy(ca))
    assert roll.shape == (B, P, P) and cls.shape == (B, 1, P)
    np.testing.assert_allclose(to_np(roll), to_np(want_roll), atol=1e-5)
    np.testing.assert_allclose(to_np(cls), to_np(want_cls), atol=1e-5)
    np.testing.assert_allclose(to_np(roll).sum(-1), 1.0, atol=1e-4)
    assert (to_np(cls) >= 0).all()
