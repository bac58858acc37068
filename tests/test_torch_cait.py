"""The port's CaiT (talking-heads self-attention, class attention, the
LayerScale blocks, ``CaiTBackbone`` and its PPNet) against the JAX package.

Each module gets the same seeded flax weights and the same numpy inputs in
both frameworks; the port runs on the CPU. Contracts:
  * modules in fp32: maps within 1e-6, outputs within 1e-5; in bf16 within
    two bf16 ulps of max|JAX output| (the products round in another order);
  * the PPNet at ``cait_micro_test`` in fp32 with discard 0.7 (trap F2,
    ``tests/test_torch_model.py``): the same top-9 set, ``cls_token_attn``
    within 1e-5, tokens, distances and logits within 1e-4;
  * at ``cait_xxs24_224`` (backbone only, B=2, seeded as
    ``tests/test_parity.py``'s CaiT selection test): fp32 gives JAX's top-81
    set; bf16 speed mode with ``rollout_discard_sample`` 1 and 8 keeps at
    least 76 of JAX's fp32 top-81 and drops only tokens of fp32 rank >= 60.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from protopformer_tpu.checkpoint import export_cait_state_dict
from protopformer_tpu.core.config import PPNetConfig, backbone_preset
from protopformer_tpu.models import CaiTBackbone as JaxCaiT
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.models import layers as j_layers
from protopformer_tpu.serving import ServingEngine as JaxServingEngine
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.models import CaiTBackbone, create_backbone
from protopformer_tpu_torch.models import layers as t_layers
from protopformer_tpu_torch.serving import ServingEngine
from tests.torch_port import (
    assert_tie_free,
    jax_params,
    port_configs,
    port_model,
    to_np,
    topk_sets,
)

# trap F2: 0.7 keeps the discard active and the micro top-9 set tie-free
BK = dataclasses.replace(backbone_preset("cait_micro_test"),
                         rollout_discard_ratio=0.7)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(1,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _torch_state(tree, prefix=""):
    """A flax module's params -> the port module's state dict (Dense
    kernels transposed, LayerNorm scale as weight)."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_torch_state(value, f"{prefix}{name}."))
            continue
        value = np.asarray(value, np.float32)
        if name == "kernel":
            name, value = "weight", value.T
        elif name == "scale":
            name = "weight"
        out[prefix + name] = torch.from_numpy(value.copy())
    return out


def _pair(j_module, t_module, seed, *inputs):
    """Seeded flax init of ``j_module`` on ``inputs``; the same weights
    loaded strictly into ``t_module``. Returns (apply, t_module)."""
    params = j_module.init(jax.random.key(seed), *inputs)["params"]
    t_module.load_state_dict(_torch_state(params), strict=True)
    return (lambda *xs: j_module.apply({"params": params}, *xs)), t_module


def _inputs(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype[0]), torch.from_numpy(x).to(dtype[1])


def _close(got, want, fp32_atol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if got.dtype == np.float32 and fp32_atol is not None:
        np.testing.assert_allclose(got, want, atol=fp32_atol)
    else:  # bf16: two ulps at max|want|
        ulp = math.ldexp(1.0, math.frexp(float(np.abs(want).max()))[1] - 8)
        np.testing.assert_allclose(got, want, atol=2 * ulp)


# --- modules ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_norm_matches_flax(rng, dtype):
    """The CaiT blocks use flax's LayerNorm (fp32 statistics, output in
    the compute dtype), which the port's ``layer_norm`` computes."""
    dt = DTYPES[dtype]
    x = (rng.normal(size=(2, 17, 24)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=24).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, size=24).astype(np.float32)
    want = nn.LayerNorm(1e-6, dtype=dt[0], param_dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}},
        jnp.asarray(x).astype(dt[0]))
    norm = torch.nn.LayerNorm(24, eps=1e-6)
    norm.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    with torch.inference_mode():
        got = t_layers.layer_norm(torch.from_numpy(x).to(dt[1]), norm, dt[1])
    assert got.dtype == dt[1]
    _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_talking_head_attention_matches_jax(rng, dtype):
    dt = DTYPES[dtype]
    jx, tx = _inputs(rng, (2, 16, 24), dt)
    apply, attn = _pair(
        j_layers.TalkingHeadAttention(2, dtype=dt[0], fuse_probs=True),
        t_layers.TalkingHeadAttention(24, 2, True, dt[1]), 1, jx)
    want_out, want_map = apply(jx)
    with torch.inference_mode():
        out, fmap = attn(tx)
    assert fmap.dtype == torch.float32 and out.dtype == dt[1]
    assert float(fmap.min()) < 0  # head-mixed maps are not probabilities
    _close(fmap, want_map, 1e-6)
    _close(out, want_out, 1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "policy"])
def test_class_attention_matches_jax(rng, dtype, masked):
    dt = DTYPES[dtype]
    jx, tx = _inputs(rng, (2, 17, 24), dt)
    keep = (rng.uniform(size=(2, 17)) > 0.4).astype(np.float32)
    keep[:, 0] = 1.0
    j_pol, t_pol = ((jnp.asarray(keep), torch.from_numpy(keep)) if masked
                    else (None, None))
    apply, attn = _pair(j_layers.ClassAttention(2, dtype=dt[0]),
                        t_layers.ClassAttention(24, 2, True, dt[1]), 2,
                        jx, j_pol)
    want_out, want_probs = apply(jx, j_pol)
    with torch.inference_mode():
        out, probs = attn(tx, t_pol)
    assert probs.shape == (2, 2, 1, 17) and probs.dtype == dt[1]
    _close(probs, want_probs, 1e-6)
    _close(out, want_out, 1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_scale_blocks_match_jax(rng, dtype):
    """Both LayerScale blocks, with gammas of 0.5 so that each branch
    shows in the output (the preset's 1e-5 would hide it)."""
    dt = DTYPES[dtype]
    jx, tx = _inputs(rng, (2, 16, 24), dt)
    jc, tc = _inputs(rng, (2, 1, 24), dt)
    apply, blk = _pair(
        j_layers.LayerScaleBlock(2, init_values=0.5, dtype=dt[0],
                                 fuse_probs=True),
        t_layers.LayerScaleBlock(24, 2, 4.0, True, 1e-5, 1e-6, dt[1]), 3, jx)
    want_x, want_map = apply(jx)
    with torch.inference_mode():
        x, fmap = blk(tx)
    _close(fmap, want_map, 1e-6)
    _close(x, want_x, 1e-5)

    keep = np.ones((2, 17), np.float32)
    keep[:, 5:9] = 0.0
    apply, blk = _pair(
        j_layers.LayerScaleBlockClassAttn(2, init_values=0.5, dtype=dt[0]),
        t_layers.LayerScaleBlockClassAttn(24, 2, 4.0, True, 1e-5, 1e-6,
                                          dt[1]),
        4, jx, jc, jnp.asarray(keep))
    want_cls, want_probs = apply(jx, jc, jnp.asarray(keep))
    with torch.inference_mode():
        cls, probs = blk(tx, tc, torch.from_numpy(keep))
    _close(probs, want_probs, 1e-6)
    _close(cls, want_cls, 1e-5)


# --- the PPNet at the micro geometry -----------------------------------------------

@pytest.fixture(scope="module")
def micro():
    params = jax_params(BK, PP, seed=0)
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 3)).astype(np.float32)
    return params, x


def test_cait_ppnet_fp32_micro_matches_jax(micro):
    params, x = micro
    want = jax.jit(j_construct(BK, PP).apply)({"params": params},
                                             jnp.asarray(x))
    model = port_model(BK, PP, params)
    assert isinstance(model.features, CaiTBackbone)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    want_attn = to_np(want.cls_token_attn)
    assert_tie_free(want_attn, 9)
    assert topk_sets(to_np(got.cls_token_attn), 9) == topk_sets(want_attn, 9)
    np.testing.assert_allclose(to_np(got.cls_token_attn), want_attn,
                               atol=1e-5)
    for field in ("distances", "logits", "logits_global", "logits_local"):
        g, w = to_np(getattr(got, field)), to_np(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=field)


def _backbone_pair(params):
    j_model = JaxCaiT(BK)
    t_model = port_model(BK, PP, params).features
    return j_model, {"params": params["features"]}, t_model


def test_cait_masked_forward_tokens_match_jax(micro):
    params, x = micro
    j_model, variables, t_model = _backbone_pair(params)
    want_x, want_attn = jax.jit(lambda v, xx: j_model.apply(
        v, xx, method=lambda m, xx: m.masked_forward(*m.embed_all(xx),
                                                      [(1, 9)])))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got_x, got_attn = t_model.masked_forward(
            *t_model.embed_all(torch.from_numpy(x)), [(1, 9)])
    assert got_x.shape == (4, 17, 24)
    np.testing.assert_allclose(to_np(got_attn), to_np(want_attn), atol=1e-5)
    np.testing.assert_allclose(to_np(got_x), to_np(want_x), atol=1e-4)
    with pytest.raises(ValueError, match=">= 1"):
        t_model.masked_forward(*t_model.embed_all(torch.from_numpy(x)),
                               [(0, 9)])


@pytest.mark.parametrize("method", ["forward_features", "feature_maps"])
def test_cait_unmasked_features_match_jax(micro, method):
    params, x = micro
    j_model, variables, t_model = _backbone_pair(params)
    want = j_model.apply(variables, jnp.asarray(x),
                         method=getattr(JaxCaiT, method))
    with torch.inference_mode():
        got = getattr(t_model, method)(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4)


def test_serving_engine_runs_a_cait_ppnet(micro):
    """The engine takes the CaiT PPNet unchanged (the normalization fold
    finds ``features.patch_embed.proj.*``) and matches JAX's engine."""
    params, _ = micro
    imgs = (np.random.default_rng(5).uniform(size=(5, 32, 32, 3))
            * 255).astype(np.uint8)
    sd = state_dict_from_jax(params, "cait", BK.depth, 3, BK.depth_token_only)
    res = ServingEngine(*port_configs(BK, PP), sd, batch_size=2,
                        compute_dtype=torch.float32, with_attn=True,
                        device="cpu")(imgs)
    want = JaxServingEngine(BK, PP, params, batch_size=2,
                            compute_dtype=jnp.float32, with_attn=True)(imgs)
    assert res.cls_token_attn.shape == (5, 16)
    np.testing.assert_allclose(res.cls_token_attn, want.cls_token_attn,
                               atol=1e-5)
    np.testing.assert_allclose(res.logits, want.logits, atol=1e-4)


def test_create_backbone_builds_cait_at_width():
    model = create_backbone("cait_xxs24_224")
    assert isinstance(model, CaiTBackbone)
    assert len(model.blocks) == 24 and len(model.blocks_token_only) == 2
    attn = model.blocks[0].attn
    assert attn.qkv.weight.shape == (576, 192)
    assert attn.proj_l.weight.shape == attn.proj_w.weight.shape == (4, 4)
    assert model.blocks_token_only[1].attn.q.weight.shape == (192, 192)
    assert model.pos_embed.shape == (1, 196, 192)
    assert float(model.blocks[3].gamma_2.detach()[0]) == pytest.approx(1e-5)


# --- cait_xxs24_224: the selection contracts --------------------------------------

@pytest.fixture(scope="module")
def production():
    """``tests/test_parity.py``'s CaiT selection fixture: seeded flax init
    of the backbone, 2 images, JAX's fp32 masked forward, run once."""
    rng = np.random.default_rng(17)
    raw = rng.normal(size=(2, 3, 224, 224)).astype(np.float32)
    x = raw.transpose(0, 2, 3, 1)
    base = backbone_preset("cait_xxs24_224", drop_path_rate=0.0)
    params = JaxCaiT(base).init(jax.random.key(2),
                                jnp.zeros((1, 224, 224, 3)))["params"]
    _, ref = JaxCaiT(base).apply(
        {"params": params}, jnp.asarray(x),
        method=lambda m, xx: m.masked_forward(*m.embed_all(xx), [(1, 81)]))
    features = {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in export_cait_state_dict(
                    params, base.depth, base.depth_token_only).items()}
    return dict(base=base, x=x, ref=np.asarray(ref), features=features)


@pytest.mark.parametrize("mode", ["fp32", "speed-sample1", "speed-sample8"])
def test_cait_224_selection_matches_jax(production, mode):
    p = production
    if mode == "fp32":
        cfg, dtype = p["base"], torch.float32
    else:
        cfg = dataclasses.replace(
            p["base"], rollout_exact_discard=False,
            rollout_discard_sample=int(mode[-1]))
        dtype = torch.bfloat16
    model = CaiTBackbone(port_configs(cfg, PP)[0], dtype)
    model.load_state_dict(p["features"], strict=True)
    with torch.inference_mode():
        _, attn = model.masked_forward(
            *model.embed_all(torch.from_numpy(p["x"])), [(1, 81)])
    got = to_np(attn)
    order = np.argsort(-p["ref"], axis=-1)
    if mode == "fp32":
        assert_tie_free(p["ref"], 81)
        assert topk_sets(got, 81) == topk_sets(p["ref"], 81)
        np.testing.assert_allclose(got, p["ref"], atol=1e-5)
        return
    for b, got_set in enumerate(topk_sets(got, 81)):
        want_set = set(order[b, :81].tolist())
        assert len(want_set & got_set) >= 76, f"sample {b}"
        rank = {int(tok): r for r, tok in enumerate(order[b])}
        assert all(rank[t] >= 60 for t in want_set - got_set), f"sample {b}"
