"""The port's kernel-off eval structure, "max"/"min" head fusion and the
batched rollout statistics against the JAX package.

``use_pallas="off"`` runs the JAX package's kernel-off structure: every
block the headloop, each stored pre-prune map through one of three
statistics routes (K2, ``masked_map_stats_multi`` at the prune point, or
``masked_map_stats`` with the probability bracket and
``rollout_discard_sample``); "max"/"min" fusion runs it whatever the
gates say, since the kernels emit the head mean. The same seeded flax
weights and numpy inputs go through both packages on the CPU (JAX's K2 in
interpret mode). Contracts: each threshold bit-equal to the JAX route's
on the same map; the maps within 1e-6 (bf16: one bf16 ulp of the largest
entry); the same top-9 selection; fp32 scores within 1e-5 and tokens
within 1e-4, bf16 tokens within serving's bound; the batched search
bit-equal to the sequential one, signed maps included.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.core.config import (
    BackboneConfig,
    PPNetConfig,
    backbone_preset,
)
from protopformer_tpu.models import DeiTBackbone as JaxDeiT
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.models import deit as j_deit
from protopformer_tpu.ops import rollout as j_rollout
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.models import construct_ppnet as t_construct
from protopformer_tpu_torch.models import deit as t_deit
from protopformer_tpu_torch.ops import rollout as t_rollout
from tests.torch_port import (
    assert_bf16_bound,
    assert_tie_free,
    bf16_ulp,
    images,
    jax_params,
    port_configs,
    port_model,
    spy_kernels,
    to_np,
    topk_sets,
)

# trap F2: a 0.7 discard keeps the top-9 sets tie-free
BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, rollout_discard_ratio=0.7,
)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# 64 patches: a 65 x 65 map spans 8 blocks of 512 lanes, so every sampled
# count reads a real subset
BK_OFF = dataclasses.replace(BK, img_size=64)


@pytest.fixture(scope="module")
def off_params():
    return jax_params(BK_OFF, PP, seed=2)


def _spy_stats(monkeypatch, module, names):
    """Record (name, maps, kwargs, [(t, s), ...]) for every call of the
    named statistics functions of ``module``."""
    seen = []

    def spy(name, fn):
        def wrapped(maps, *args, **kwargs):
            out = fn(maps, *args, **kwargs)
            if isinstance(maps, list):  # the caller clears its list
                maps = list(maps)
            seen.append((name, maps, args, kwargs,
                         out if isinstance(out, list) else [out]))
            return out
        return wrapped

    for name in names:
        monkeypatch.setattr(module, name, spy(name, getattr(module, name)))
    return seen


STATS = ("masked_map_stats", "masked_map_stats_multi", "fused_map_stats")


def _masked_both(monkeypatch, params, j_bk, t_bk, x, dtype=DTYPES["float32"]):
    """Both masked forwards, JAX eagerly (its K2 in interpret mode). Returns
    ((x, cls_token_attn, the port's statistics calls), (JAX's x,
    cls_token_attn, maps))."""
    from protopformer_tpu.kernels import stats as j_stats

    monkeypatch.setattr(j_stats, "fused_map_stats", functools.partial(
        j_stats.fused_map_stats, interpret=True))
    j_seen = _spy_stats(monkeypatch, j_deit, STATS[:2])
    j_seen_k2 = _spy_stats(monkeypatch, j_stats, STATS[2:])
    t_seen = _spy_stats(monkeypatch, t_deit, STATS)
    want_x, want_attn = JaxDeiT(j_bk, compute_dtype=dtype[0]).apply(
        {"params": params["features"]}, jnp.asarray(x),
        method=lambda m, im: m.masked_forward(*m.embed_all(im), [(2, 9)]))
    model = t_construct(t_bk, port_configs(j_bk, PP)[1], dtype[1])
    model.load_state_dict(state_dict_from_jax(params, "deit", j_bk.depth, 3),
                          strict=True)
    backbone = model.eval().features
    with torch.inference_mode():
        got_x, got_attn = backbone.masked_forward(
            *backbone.embed_all(torch.from_numpy(x)), [(2, 9)])
    j_maps = []
    for _, maps, *_ in j_seen + j_seen_k2:
        j_maps += maps if isinstance(maps, list) else [maps]
    return (got_x, got_attn, t_seen), (want_x, want_attn, j_maps)


def _hold_stats(t_seen, j_maps, j_fn_of):
    """Each statistics call of the port against the JAX function of its
    route on the port's own maps: t bit-equal, s within 1e-6; and the
    port's maps within 1e-6 of JAX's, bf16 maps within one bf16 ulp of
    their largest entry (the two forwards' maps differ by the products'
    rounding, so a threshold is compared on one map)."""
    t_maps = []
    for name, maps, args, kwargs, outs in t_seen:
        multi = isinstance(maps, list)
        maps = maps if multi else [maps]
        t_maps += maps
        j_in = [jnp.asarray(to_np(m)).astype(
            jnp.bfloat16 if m.dtype == torch.bfloat16 else jnp.float32)
            for m in maps]
        want = j_fn_of(name)(j_in if multi else j_in[0], *args, **kwargs)
        want = want if multi else [want]
        for (t, s), (jt, js) in zip(outs, want, strict=True):
            assert to_np(t).tobytes() == to_np(jt).tobytes(), name
            np.testing.assert_allclose(to_np(s), to_np(js), atol=1e-6)
    assert len(t_maps) == len(j_maps) == 2
    for m, jm in zip(t_maps, j_maps):
        atol = 1e-6 if m.dtype == torch.float32 else bf16_ulp(to_np(jm))
        np.testing.assert_allclose(to_np(m), to_np(jm), atol=atol)


def _j_stats_fn(name):
    from protopformer_tpu.kernels import stats as j_stats

    if name == "fused_map_stats":
        return functools.partial(j_stats.fused_map_stats, interpret=True)
    return getattr(j_rollout, name)


def _off_configs(**overrides):
    """(JAX config, port config with the kernels off) at BK_OFF."""
    j_bk = dataclasses.replace(BK_OFF, **overrides)
    t_bk = dataclasses.replace(port_configs(j_bk, PP)[0], use_pallas="off",
                               stats_kernel="off")
    return j_bk, t_bk


def _same_selection(got_attn, want_attn):
    want_attn = to_np(want_attn)
    assert_tie_free(want_attn, 9)
    assert topk_sets(to_np(got_attn), 9) == topk_sets(want_attn, 9)


@pytest.mark.parametrize("sample,batched", [
    (1, "off"), (2, "off"), (4, "off"), (8, "off"), (1, "on"), (4, "on"),
], ids=["exact", "speed-2", "speed-4", "speed-8", "exact-batched",
        "speed-4-batched"])
def test_kernel_off_masked_forward_matches_jax(monkeypatch, off_params,
                                               sample, batched):
    """``use_pallas``/``stats_kernel`` "off": no kernel; each threshold
    bit-equal to the JAX route's on the same map, the same top-9
    selection, scores within 1e-5 and tokens within 1e-4 of JAX's."""
    exact = sample == 1  # sampled counts are speed mode only
    j_bk, t_bk = _off_configs(rollout_discard_sample=sample,
                              rollout_exact_discard=exact,
                              rollout_stats_batched=batched)
    calls = spy_kernels(monkeypatch)
    got, want = _masked_both(monkeypatch, off_params, j_bk, t_bk,
                             images(12, size=64))
    assert sum(calls.values()) == 0
    routes = {name for name, *_ in got[2]}
    assert routes == {"masked_map_stats_multi" if batched == "on"
                      else "masked_map_stats"}
    _hold_stats(got[2], want[2], _j_stats_fn)
    _same_selection(got[1], want[1])
    np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), atol=1e-5)
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), atol=1e-4)


def test_kernel_off_bf16_speed_runs_k2_and_matches_jax(monkeypatch,
                                                       off_params):
    """bf16 speed with ``use_pallas="off"`` and ``stats_kernel`` on: the
    headloop's maps, stored bf16, go through K2's 16-bit prefix select
    (here its plain version), as JAX's kernel-off structure sends them
    through ``fused_map_stats`` (its kernel in interpret mode); no
    attention kernel."""
    j_bk = dataclasses.replace(BK_OFF, rollout_exact_discard=False,
                               stats_kernel="on")
    t_bk = dataclasses.replace(port_configs(j_bk, PP)[0], use_pallas="off",
                               stats_kernel="on")
    calls = spy_kernels(monkeypatch)
    got, want = _masked_both(monkeypatch, off_params, j_bk, t_bk,
                             images(13, size=64), DTYPES["bfloat16"])
    assert calls["fused_map_stats"] == 2 and sum(calls.values()) == 2
    t_k2 = [c for c in got[2] if c[0] == "fused_map_stats"]
    assert len(t_k2) == 2 and all(c[1].dtype == torch.bfloat16 for c in t_k2)
    for _, fmap, args, kwargs, [(t, s)] in t_k2:
        jt, js = _j_stats_fn("fused_map_stats")(
            jnp.asarray(to_np(fmap)).astype(jnp.bfloat16), *args, **kwargs)
        assert to_np(t).tobytes() == to_np(jt).tobytes()
        np.testing.assert_allclose(to_np(s), to_np(js), atol=1e-6)
    _same_selection(got[1], want[1])
    assert_bf16_bound(got[0], want[0])


@pytest.mark.parametrize("fusion", ["max", "min"])
def test_head_fusion_max_min_matches_jax(monkeypatch, off_params, fusion):
    """The blocks return per-head probabilities (no kernel: the kernels'
    map is the head mean), fused and then through the statistics route;
    with the port's default gates K2's plain version serves them."""
    j_bk = dataclasses.replace(BK_OFF, rollout_head_fusion=fusion)
    t_bk = port_configs(j_bk, PP)[0]
    calls = spy_kernels(monkeypatch)
    got, want = _masked_both(monkeypatch, off_params, j_bk, t_bk,
                             images(14, size=64))
    assert calls["fused_map_stats"] == 2
    assert sum(calls.values()) == 2
    want_attn = to_np(want[1])
    assert_tie_free(want_attn, 9)
    assert topk_sets(to_np(got[1]), 9) == topk_sets(want_attn, 9)
    np.testing.assert_allclose(to_np(got[1]), want_attn, atol=1e-5)
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), atol=1e-4)


@pytest.mark.parametrize("fusion", ["max", "min"])
def test_thresh_forward_head_fusion_matches_jax(off_params, fusion):
    """``masked_forward_thresh`` normalizes the fused per-head maps."""
    bk = dataclasses.replace(BK_OFF, rollout_head_fusion=fusion)
    x = images(15, size=64)
    token_attn = np.random.default_rng(16).uniform(
        0, 2.0 / 64, size=(4, 64)).astype(np.float32)
    want_x, want_attn = JaxDeiT(bk).apply(
        {"params": off_params["features"]}, jnp.asarray(x),
        method=lambda m, im: m.masked_forward_thresh(
            *m.embed_all(im), jnp.asarray(token_attn), [(2, 9)]))
    backbone = port_model(bk, PP, off_params).features
    with torch.inference_mode():
        got_x, got_attn = backbone.masked_forward_thresh(
            *backbone.embed_all(torch.from_numpy(x)),
            torch.from_numpy(token_attn), [(2, 9)])
    np.testing.assert_allclose(to_np(got_attn), to_np(want_attn), atol=1e-5)
    np.testing.assert_allclose(to_np(got_x), to_np(want_x), atol=1e-4)


def test_kernel_off_ppnet_matches_the_kernel_on_structure(off_params):
    """fp32, sample 1: the two structures are the same function (logits
    within 1e-4, the same top-9)."""
    on = port_model(BK_OFF, PP, off_params)
    off = t_construct(_off_configs()[1], port_configs(BK_OFF, PP)[1])
    off.load_state_dict(on.state_dict(), strict=True)
    x = torch.from_numpy(images(17, size=64))
    with torch.inference_mode():
        a, b = on(x), off.eval()(x)
    assert topk_sets(to_np(a.cls_token_attn), 9) == topk_sets(
        to_np(b.cls_token_attn), 9)
    np.testing.assert_allclose(to_np(a.logits), to_np(b.logits), atol=1e-4)


# --- CaiT: batched statistics and head fusion ------------------------------------

CAIT = dataclasses.replace(backbone_preset("cait_micro_test"),
                           rollout_discard_ratio=0.7)
CAIT_PP = dataclasses.replace(PP, reserve_layers=(1,))


@pytest.mark.parametrize("overrides", [
    {"rollout_stats_batched": "on"},
    {"rollout_stats_batched": "on", "rollout_exact_discard": False},
    {"rollout_head_fusion": "max"},
    {"rollout_head_fusion": "min"},
], ids=["batched-exact", "batched-speed", "max", "min"])
def test_cait_batched_stats_and_head_fusion_match_jax(overrides):
    bk = dataclasses.replace(CAIT, **overrides)
    params = jax_params(bk, CAIT_PP, seed=3)
    x = images(18)
    want = jax.jit(j_construct(bk, CAIT_PP).apply)({"params": params},
                                                   jnp.asarray(x))
    model = port_model(bk, CAIT_PP, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    want_attn = to_np(want.cls_token_attn)
    assert topk_sets(to_np(got.cls_token_attn), 9) == topk_sets(want_attn, 9)
    # 1e-5 on probability-scale scores; "min" fusion's signed maps reach
    # ~9 in magnitude, where fp32 rounding alone is of the order of 1e-5
    np.testing.assert_allclose(
        to_np(got.cls_token_attn), want_attn,
        atol=1e-5 * max(1.0, float(np.abs(want_attn).max())))
    np.testing.assert_allclose(to_np(got.logits), to_np(want.logits),
                               atol=1e-4, rtol=1e-4)


# --- masked_map_stats_multi -----------------------------------------------------------

def _stack_maps(rng, signed, L=3, B=2, N=33):
    maps = rng.uniform(size=(L, B, N, N)).astype(np.float32) ** 4
    maps /= maps.sum(-1, keepdims=True)
    if signed:
        maps = maps - rng.uniform(0.0, 2.0 / N, size=(L, B, 1, 1)).astype(
            np.float32)
    return maps


@pytest.mark.parametrize("case", [
    dict(exact=True),
    dict(exact=True, bound=True),
    dict(exact=False),
    dict(exact=False, bf16=True, bound=True),
    dict(exact=False, bf16=True, sample=4, bound=True),
    dict(exact=False, sample=2),
    dict(exact=True, signed=True),
    dict(exact=False, bf16=True, signed=True, sample=2),
], ids=["exact", "exact-bound", "prefix16", "bf16-bound", "bf16-sample4",
        "prefix16-sample2", "signed", "signed-bf16-sample2"])
def test_masked_map_stats_multi_matches_jax_and_the_sequential(rng, case):
    """Bit-equal per layer to the sequential ``masked_map_stats`` (t and
    s), and t bit-equal to JAX's ``masked_map_stats_multi``."""
    signed = case.get("signed", False)
    maps = _stack_maps(rng, signed)
    kw = dict(sample=case.get("sample", 1), signed=signed)
    if case.get("bound"):
        kw.update(value_bound=1.0, stochastic_eps=1e-6)
    t_maps = [torch.from_numpy(m) for m in maps]
    j_maps = [jnp.asarray(m) for m in maps]
    if case.get("bf16"):
        t_maps = [m.to(torch.bfloat16) for m in t_maps]
        j_maps = [m.astype(jnp.bfloat16) for m in j_maps]
    got = t_rollout.masked_map_stats_multi(t_maps, 0.9, case["exact"], **kw)
    seq = [t_rollout.masked_map_stats(m, 0.9, case["exact"], **kw)
           for m in t_maps]
    want = j_rollout.masked_map_stats_multi(j_maps, 0.9, case["exact"], **kw)
    assert len(got) == len(want) == 3
    for (t, s), (qt, qs), (jt, js) in zip(got, seq, want):
        assert torch.equal(t, qt) and torch.equal(s, qs)
        assert t.dtype == qt.dtype
        assert to_np(t).tobytes() == to_np(jt).tobytes()
        np.testing.assert_allclose(to_np(s), to_np(js), atol=1e-6)


def test_masked_map_stats_multi_single_map_and_no_discard(rng):
    maps = [torch.from_numpy(m) for m in _stack_maps(rng, False)]
    (t, s), = t_rollout.masked_map_stats_multi(maps[:1], 0.9, True)
    qt, qs = t_rollout.masked_map_stats(maps[0], 0.9, True)
    assert torch.equal(t, qt) and torch.equal(s, qs)
    for (t, s), m in zip(t_rollout.masked_map_stats_multi(maps, 0.0, True),
                         maps):
        assert bool(torch.isinf(t).all()) and torch.equal(s, m.sum(-1))
