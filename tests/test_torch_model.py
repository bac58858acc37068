"""The PyTorch port's PPNet eval forward against the JAX package's.

The same seeded JAX weights go through ``state_dict_from_jax`` into the
port; the same numpy images go through both forwards (the port on the
CPU, where its kernels run their plain versions; JAX with its defaults,
kernels off). Contracts, from tests/test_parity.py:
  * fp32: the same top-k token set, ``cls_token_attn`` within 1e-5,
    distances and logits within 1e-4 (absolute and relative);
  * bf16 (speed and exact discard): at least 74 of the fp32 top-81 tokens
    kept and only tokens of fp32 rank >= 64 dropped; logits within 2e-2
    relative plus 2e-2 * max|logits| absolute of JAX's bf16 forward.
"""

import dataclasses

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
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.models import construct_ppnet as t_construct
from tests.torch_port import (
    assert_tie_free,
    jax_params,
    port_configs,
    port_model,
    to_np,
    topk_sets,
)

# trap F2 (ties in top-k): over 17 tokens the 0.9 discard leaves fewer than
# 10 non-zero CLS rollout scores, so the top-9 set would depend on how each
# framework breaks ties; 0.7 keeps the discard active and the set tie-free
BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, rollout_discard_ratio=0.7,
)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)


def _forward_both(backbone, ppnet, params, x, dtype):
    j_model = j_construct(backbone, ppnet, compute_dtype=dtype)
    want = jax.jit(j_model.apply)({"params": params}, jnp.asarray(x))
    model = port_model(backbone, ppnet, params,
                       torch.float32 if dtype == jnp.float32
                       else torch.bfloat16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    return got, want


def _assert_fp32_contract(got, want, k):
    want_attn = to_np(want.cls_token_attn)
    assert_tie_free(want_attn, k)
    assert topk_sets(to_np(got.cls_token_attn), k) == topk_sets(want_attn, k)
    np.testing.assert_allclose(to_np(got.cls_token_attn), want_attn,
                               atol=1e-5)
    for field in ("distances", "logits", "logits_global", "logits_local"):
        g, w = to_np(getattr(got, field)), to_np(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=field)


@pytest.mark.parametrize("prune_gather", ["auto", "on"])
def test_ppnet_fp32_micro_matches_jax(prune_gather):
    """Micro geometry; 'auto' keeps the policy mask in fp32, 'on' gathers
    the kept tokens at the prune point (the bf16 structure, in fp32)."""
    bk = dataclasses.replace(BK, prune_gather=prune_gather)
    params = jax_params(bk, PP, seed=0)
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 3)).astype(np.float32)
    got, want = _forward_both(bk, PP, params, x, jnp.float32)
    _assert_fp32_contract(got, want, PP.final_reserve_num)


@pytest.fixture(scope="module")
def production():
    """DeiT-Tiny/16@224, 12 blocks, prune at 11 keeping 81, 2000 local +
    2000 global prototypes: seeded JAX weights, 4 images, the JAX fp32
    forward."""
    bk = backbone_preset("deit_tiny_patch16_224")
    pp = PPNetConfig()
    params = jax_params(bk, pp, seed=0)
    x = np.random.default_rng(11).normal(size=(4, 224, 224, 3))
    x = x.astype(np.float32)
    fp32 = jax.jit(j_construct(bk, pp).apply)({"params": params},
                                             jnp.asarray(x))
    return dict(backbone=bk, ppnet=pp, params=params, x=x, fp32=fp32)


def test_ppnet_fp32_production_matches_jax(production):
    p = production
    model = port_model(p["backbone"], p["ppnet"], p["params"])
    with torch.inference_mode():
        got = model(torch.from_numpy(p["x"]))
    assert got.distances.shape == (4, 2000, 9, 9)
    _assert_fp32_contract(got, p["fp32"], 81)


@pytest.mark.parametrize("exact", [False, True], ids=["speed", "exact"])
def test_ppnet_bf16_production_selection_and_logits(production, exact):
    p = production
    bk = dataclasses.replace(p["backbone"], rollout_exact_discard=exact)
    got, want = _forward_both(bk, p["ppnet"], p["params"], p["x"],
                              jnp.bfloat16)
    fp32_order = np.argsort(-to_np(p["fp32"].cls_token_attn), axis=-1)
    got_sets = topk_sets(to_np(got.cls_token_attn), 81)
    for b, got_set in enumerate(got_sets):
        want_set = set(fp32_order[b, :81].tolist())
        assert len(want_set & got_set) >= 74, f"sample {b}"
        rank = {int(tok): r for r, tok in enumerate(fp32_order[b])}
        assert all(rank[t] >= 64 for t in want_set - got_set), f"sample {b}"
    logits, want_logits = to_np(got.logits), to_np(want.logits)
    np.testing.assert_allclose(
        logits, want_logits, rtol=2e-2,
        atol=2e-2 * float(np.abs(want_logits).max()),
    )


# --- configuration ---------------------------------------------------------------

def test_port_config_copies_the_jax_fields_and_presets():
    from protopformer_tpu.core import config as j_config

    for cls in ("BackboneConfig", "PPNetConfig"):
        j_fields = dataclasses.fields(getattr(j_config, cls))
        t_fields = dataclasses.fields(getattr(t_config, cls))
        assert [f.name for f in t_fields] == [f.name for f in j_fields]
        for jf, tf in zip(j_fields, t_fields):
            if tf.name in ("use_pallas", "stats_kernel"):
                assert tf.default == "auto"
            else:
                assert tf.default == jf.default, tf.name
    assert set(t_config.BACKBONE_PRESETS) == set(j_config.BACKBONE_PRESETS)
    for name, cfg in t_config.BACKBONE_PRESETS.items():
        want = dataclasses.asdict(j_config.BACKBONE_PRESETS[name])
        got = dataclasses.asdict(cfg)
        for gate in ("use_pallas", "stats_kernel"):
            want.pop(gate), got.pop(gate)
        assert got == want, name
    with pytest.raises(ValueError):
        t_config.BackboneConfig(use_pallas="maybe")
    with pytest.raises(ValueError):
        t_config.BackboneConfig(rollout_discard_sample=4)


@pytest.mark.parametrize("field,value", [
    ("attn_impl", "batched"),
    ("patch_embed", "matmul"),
    ("ln_stats", "mxu"),
    ("quantize", "int8"),
])
def test_values_not_ported_raise(field, value):
    """Only the XLA lowering choices and int8 serving (ROADMAP item 14)."""
    bk, pp = port_configs(BK, PP)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        t_construct(dataclasses.replace(bk, **{field: value}), pp)


def test_cait_ppnet_never_gathers():
    """A bf16 CaiT PPNet keeps the policy mask, since only DeiT's masked
    forward gathers at the prune point."""
    bk = t_config.backbone_preset("cait_micro_test")
    pp = t_config.PPNetConfig(
        prototype_shape=(40, 16, 1, 1), num_classes=4,
        reserve_layers=(1,), reserve_token_nums=(9,),
    )
    for gather in ("auto", "on"):
        model = t_construct(dataclasses.replace(bk, prune_gather=gather), pp,
                            torch.bfloat16)
        assert not model._gather_at_prune()
    deit = t_construct(*port_configs(BK, PP), torch.bfloat16)
    assert deit._gather_at_prune()


# --- masked_forward_thresh (eager rollout) -----------------------------------

def _thresh_inputs(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    token_attn = rng.uniform(0, 2.0 / 16, size=(2, 16)).astype(np.float32)
    return x, token_attn


def test_masked_forward_thresh_fp32_matches_jax():
    """tests/test_models.py::test_deit_masked_forward_thresh's call on the
    same weights in both frameworks: cls_token_attn within 1e-5, x within
    1e-4."""
    params = jax_params(BK, PP, seed=0)
    x, token_attn = _thresh_inputs()
    want_x, want_attn = jax.jit(lambda p, im, ta: j_construct(BK, PP).apply(
        {"params": p}, im,
        method=lambda m, im: m.features.masked_forward_thresh(
            *m.features.embed_all(im), ta, [(2, 9)]
        ),
    ))(params, jnp.asarray(x), jnp.asarray(token_attn))
    backbone = port_model(BK, PP, params).features
    with torch.inference_mode():
        got_x, got_attn = backbone.masked_forward_thresh(
            *backbone.embed_all(torch.from_numpy(x)),
            torch.from_numpy(token_attn), [(2, 9)],
        )
    assert got_x.shape == (2, 17, 24) and got_attn.shape == (2, 16)
    np.testing.assert_allclose(to_np(got_attn), to_np(want_attn), atol=1e-5)
    np.testing.assert_allclose(to_np(got_x), to_np(want_x), atol=1e-4)


@pytest.mark.parametrize("exact", [False, True], ids=["speed", "exact"])
def test_masked_forward_thresh_bf16_matches_jax(exact):
    """The same call in bf16 (exact: K4's plain version on the pre-prune
    blocks; speed: K3's and the prefix normalize): cls_token_attn and x
    within serving's bf16 bound of JAX's bf16 forward, rtol 2e-2 plus
    2e-2 * max|JAX|."""
    bk = dataclasses.replace(BK, rollout_exact_discard=exact)
    params = jax_params(bk, PP, seed=0)
    x, token_attn = _thresh_inputs()
    want_x, want_attn = jax.jit(lambda p, im, ta: j_construct(
        bk, PP, compute_dtype=jnp.bfloat16).apply(
        {"params": p}, im,
        method=lambda m, im: m.features.masked_forward_thresh(
            *m.features.embed_all(im), ta, [(2, 9)]
        ),
    ))(params, jnp.asarray(x), jnp.asarray(token_attn))
    backbone = port_model(bk, PP, params, torch.bfloat16).features
    with torch.inference_mode():
        got_x, got_attn = backbone.masked_forward_thresh(
            *backbone.embed_all(torch.from_numpy(x)),
            torch.from_numpy(token_attn), [(2, 9)],
        )
    assert got_x.dtype == torch.bfloat16 and got_attn.dtype == torch.float32
    for got, want in ((got_attn, want_attn), (got_x, want_x)):
        want = to_np(want)
        np.testing.assert_allclose(to_np(got), want, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype,exact,want", [
    (torch.bfloat16, True, {"core": 2, "mean": 1}),
    (torch.bfloat16, False, {"core": 0, "mean": 3}),
    (torch.float32, True, {"core": 2, "mean": 1}),
], ids=["bf16-exact", "bf16-speed", "fp32"])
def test_masked_forward_thresh_routes(monkeypatch, dtype, exact, want):
    """The pre-prune blocks take K4 with exact discard (K3 and the prefix
    normalize otherwise), the others K3; K1 never runs (tap=False)."""
    from protopformer_tpu_torch.models import layers

    calls = {"core": 0, "mean": 0, "block_stats": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(layers, fn.__name__, wrapped)

    spy("core", layers.fused_attention_core)
    spy("mean", layers.fused_attention_mean_padded)
    spy("block_stats", layers.fused_attention_block_stats)
    bk, pp = port_configs(
        dataclasses.replace(BK, rollout_exact_discard=exact), PP
    )
    backbone = t_construct(bk, pp, dtype,
                           generator=torch.Generator().manual_seed(0)).features
    x, token_attn = _thresh_inputs()
    with torch.inference_mode():
        out, attn = backbone.masked_forward_thresh(
            *backbone.embed_all(torch.from_numpy(x)),
            torch.from_numpy(token_attn), [(2, 9)],
        )
    assert calls == dict(want, block_stats=0)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert torch.isfinite(attn).all() and (attn >= 0).all()


@pytest.mark.parametrize("ndim", [3, 4])
def test_normalize_block_attention_matches_jax(rng, ndim):
    from protopformer_tpu.models.deit import normalize_block_attention as j_nba
    from protopformer_tpu_torch.models.deit import normalize_block_attention

    probs = rng.uniform(size=(2, 2, 17, 17)).astype(np.float32) + 1e-3
    probs /= probs.sum(-1, keepdims=True)
    if ndim == 3:
        probs = probs.mean(1)
    bk, _ = port_configs(BK, PP)
    want = j_nba(jnp.asarray(probs), BK)
    got = normalize_block_attention(torch.from_numpy(probs), bk)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)
