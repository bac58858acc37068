"""The rest of the port's DeiT model layer against the JAX package: the
no-policy attention, the unpruned forwards, ``DistilledDeiT``, the
bottleneck add-on, ``push_forward``, ``BaseNet`` and the DeiT-S/B
presets' parameter shapes; and the kernel structure as the default gates'
choice. The kernel-off structure, head fusion and the batched statistics
are in ``test_torch_rollout_routes.py``.

The same seeded flax weights reach the port through its converters and
load with ``strict=True``; the same numpy inputs go through both (the
port on the CPU, where its kernels run their plain versions; JAX with its
defaults, kernels off). Contracts:
  * fp32 modules: outputs within 1e-5 (one block, the patch embedding) or
    1e-4 (a whole backbone, logits, distances, activations), rollout
    scores within 1e-5 with the same top-k set;
  * bf16: one block within one bf16 ulp of max|JAX output|; a whole
    forward within rtol 2e-2 plus 2e-2 * max|JAX| (serving's bf16 bound).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.checkpoint import (
    export_deit_state_dict,
    export_ppnet_state_dict,
)
from protopformer_tpu.core.config import (
    BackboneConfig,
    PPNetConfig,
    backbone_preset,
)
from protopformer_tpu.models import BaseNet as JaxBaseNet
from protopformer_tpu.models import DeiTBackbone as JaxDeiT
from protopformer_tpu.models import DistilledDeiT as JaxDistilled
from protopformer_tpu.models import PPNet as JaxPPNet
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.models import create_backbone as j_create_backbone
from protopformer_tpu.models import layers as j_layers
from protopformer_tpu.models.ppnet import AddOnLayers as JaxAddOn
from protopformer_tpu_torch.checkpoint import (
    basenet_state_dict_from_jax,
    deit_state_dict_from_jax,
    state_dict_from_jax,
)
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.models import (
    DistilledDeiT,
    PushOutput,
    construct_basenet,
    construct_distilled_deit,
    create_backbone,
)
from protopformer_tpu_torch.models import construct_ppnet as t_construct
from protopformer_tpu_torch.models import layers as t_layers
from protopformer_tpu_torch.models.ppnet import AddOnLayers
from protopformer_tpu_torch.serving import ServingEngine
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

# trap F2: a 0.7 discard keeps the micro top-9 sets tie-free
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


def _torch_state(tree, prefix=""):
    """A flax module's params -> the port module's state dict."""
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


@pytest.fixture(scope="module")
def micro():
    return jax_params(BK, PP, seed=0)


# --- the no-policy block -----------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_none_policy_block_matches_jax(rng, dtype):
    """A plain softmax over fp32 logits, cast back to the compute dtype,
    no eps terms and no map: fp32 within 1e-5, bf16 within one bf16 ulp
    of max|out|."""
    jd, td = DTYPES[dtype]
    x = rng.normal(size=(2, 17, 24)).astype(np.float32)
    j_block = j_layers.Block(num_heads=2, dtype=jd, fuse_probs=True)
    params = j_block.init(jax.random.key(3), jnp.asarray(x).astype(jd),
                          None)["params"]
    want, _ = j_block.apply({"params": params}, jnp.asarray(x).astype(jd),
                            None)
    block = t_layers.Block(24, 2, 4.0, True, 1e-6, td, (0.9, 0.2, True))
    block.load_state_dict(_torch_state(params), strict=True)
    with torch.inference_mode():
        got, aux = block.eval()(torch.from_numpy(x).to(td), None)
    assert aux is None and got.dtype == td
    atol = 1e-5 if dtype == "float32" else bf16_ulp(to_np(want))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol)


# --- the unpruned forwards ----------------------------------------------------------

@pytest.mark.parametrize("method,atol", [
    ("embed_patches", 1e-5), ("feature_maps", 1e-4),
    ("forward_features", 1e-4), ("__call__", 1e-4),
])
def test_unpruned_forwards_match_jax(micro, method, atol):
    x = images(1)
    want = JaxDeiT(BK).apply({"params": micro["features"]}, jnp.asarray(x),
                             method=getattr(JaxDeiT, method))
    backbone = port_model(BK, PP, micro).features
    fn = backbone.forward if method == "__call__" else getattr(backbone,
                                                               method)
    with torch.inference_mode():
        got = fn(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol)


def test_unpruned_forward_bf16_matches_jax(micro):
    x = images(2)
    want = JaxDeiT(BK, compute_dtype=jnp.bfloat16).apply(
        {"params": micro["features"]}, jnp.asarray(x),
        method=JaxDeiT.feature_maps)
    backbone = port_model(BK, PP, micro, torch.bfloat16).features
    with torch.inference_mode():
        got = backbone.feature_maps(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert_bf16_bound(got, want)


def test_unpruned_forwards_launch_no_kernel(micro, monkeypatch):
    """No policy, no kernel: the JAX kernel gate needs a policy."""
    calls = spy_kernels(monkeypatch)
    backbone = port_model(BK, PP, micro, torch.bfloat16).features
    with torch.inference_mode():
        backbone.forward_features(torch.from_numpy(images(3)))
    assert sum(calls.values()) == 0


# --- DistilledDeiT ------------------------------------------------------------------

DIST = dataclasses.replace(BK, distilled=True, drop_path_rate=0.0)


@pytest.fixture(scope="module")
def distilled():
    model = JaxDistilled(DIST, num_classes=5)
    params = model.init(jax.random.key(4), jnp.zeros((1, 32, 32, 3)))
    return model, params["params"]


def _port_distilled(params, dtype=torch.float32):
    model = DistilledDeiT(port_configs(DIST, PP)[0], num_classes=5,
                          compute_dtype=dtype)
    model.load_state_dict(deit_state_dict_from_jax(params, DIST.depth),
                          strict=True)
    return model


def test_deit_state_dict_equals_the_jax_export(distilled):
    _, params = distilled
    got = deit_state_dict_from_jax(params, DIST.depth)
    want = export_deit_state_dict(params, DIST.depth)
    assert set(got) == set(want)
    assert {"dist_token", "head.weight", "head_dist.bias"} <= set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_distilled_deit_matches_jax(distilled, train):
    """Eval: the mean of the two heads; training: both heads (drop path
    and dropout 0, so the two frameworks draw nothing)."""
    j_model, params = distilled
    x = images(5)
    want = j_model.apply({"params": params}, jnp.asarray(x), train=train)
    model = _port_distilled(params).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if not train:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (4, 5) and g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), to_np(w), atol=1e-4, rtol=1e-4)


def test_distilled_ppnet_raises_value_error_in_both():
    """Both registries build the two-head classifier from a distilled
    config, and both PPNets reject it with ValueError."""
    assert isinstance(j_create_backbone("deit_tiny_distilled_patch16_224"),
                      JaxDistilled)
    assert isinstance(create_backbone("deit_tiny_distilled_patch16_224"),
                      DistilledDeiT)
    with pytest.raises(ValueError, match="distilled"):
        j_construct(DIST, PP).init(jax.random.key(0),
                                   jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="distilled"):
        t_construct(*port_configs(DIST, PP))


# --- the bottleneck add-on ----------------------------------------------------------

BK64 = dataclasses.replace(BK, embed_dim=64)
PP_BOTTLENECK = dataclasses.replace(PP, add_on_layers_type="bottleneck")


def test_bottleneck_layout_is_the_reference_sequential():
    """64 -> 16: two halving pairs, conv j at index 2j, the ReLUs between
    and a sigmoid last; the regular stack is conv + sigmoid."""
    stack = AddOnLayers(64, 16, torch.float32, "bottleneck")
    kinds = [type(m).__name__ for m in stack]
    assert kinds == ["Conv2d", "ReLU", "Conv2d", "ReLU",
                     "Conv2d", "ReLU", "Conv2d", "Sigmoid"]
    assert [tuple(stack[i].weight.shape[:2]) for i in (0, 2, 4, 6)] == [
        (32, 64), (32, 32), (16, 32), (16, 16)]
    regular = AddOnLayers(64, 16, torch.float32)
    assert [type(m).__name__ for m in regular] == ["Conv2d", "Sigmoid"]
    with pytest.raises(ValueError, match="add_on_layers_type"):
        AddOnLayers(64, 16, torch.float32, "deep")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bottleneck_add_on_matches_jax(rng, dtype):
    jd, td = DTYPES[dtype]
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    j_mod = JaxAddOn(in_dim=64, proto_dim=16, kind="bottleneck", dtype=jd)
    params = j_mod.init(jax.random.key(5), jnp.asarray(x))["params"]
    want = j_mod.apply({"params": params}, jnp.asarray(x))
    sd = {}
    for j in range(len(params)):
        layer = params[f"layers_{j}"]
        sd[f"{2 * j}.weight"] = torch.from_numpy(
            np.asarray(layer["kernel"]).T[:, :, None, None].copy())
        sd[f"{2 * j}.bias"] = torch.from_numpy(
            np.array(layer["bias"], np.float32))
    stack = AddOnLayers(64, 16, td, "bottleneck")
    stack.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = stack(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the sigmoid is fp32
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)
    else:
        assert_bf16_bound(got, want)


def test_bottleneck_ppnet_loads_strict_and_matches_jax():
    params = jax_params(BK64, PP_BOTTLENECK, seed=1)
    sd = state_dict_from_jax(params, "deit", BK64.depth, 3)
    want_sd = export_ppnet_state_dict(params, "deit", BK64.depth,
                                      global_proto_per_class=3)
    assert set(sd) == set(want_sd)
    assert {f"add_on_layers.{i}.weight" for i in (0, 2, 4, 6)} <= set(sd)
    for key, value in want_sd.items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(value),
                                      err_msg=key)
    model = port_model(BK64, PP_BOTTLENECK, params)  # strict load
    x = images(6)
    want = jax.jit(j_construct(BK64, PP_BOTTLENECK).apply)(
        {"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert_tie_free(to_np(want.cls_token_attn), 9)
    assert (topk_sets(to_np(got.cls_token_attn), 9)
            == topk_sets(to_np(want.cls_token_attn), 9))
    for field in ("distances", "logits"):
        np.testing.assert_allclose(to_np(getattr(got, field)),
                                   to_np(getattr(want, field)),
                                   atol=1e-4, rtol=1e-4, err_msg=field)


# --- push_forward -------------------------------------------------------------------

def _push_both(params, dtype, x):
    want = jax.jit(lambda p, im: j_construct(BK, PP, compute_dtype=dtype[0])
                   .apply({"params": p}, im, method=JaxPPNet.push_forward))(
        params, jnp.asarray(x))
    model = port_model(BK, PP, params, dtype[1]).train()
    got = model.push_forward(torch.from_numpy(x))
    assert model.training  # push_forward restores the caller's mode
    return model.eval(), got, want


def test_push_forward_fp32_matches_jax(micro):
    x = images(7)
    model, got, want = _push_both(micro, DTYPES["float32"], x)
    assert isinstance(got, PushOutput)
    assert got.proto_acts.shape == (4, 40, 3, 3)
    np.testing.assert_allclose(to_np(got.cls_token_attn),
                               to_np(want.cls_token_attn), atol=1e-5)
    np.testing.assert_allclose(to_np(got.proto_acts), to_np(want.proto_acts),
                               atol=1e-4, rtol=1e-4)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert torch.equal(out.cls_token_attn, got.cls_token_attn)


def test_push_forward_bf16_gathers_and_matches_jax(micro):
    """bf16 gathers at the prune point: the 3x3 grid is over the kept
    tokens in ascending token order (``topk_sorted_indices``), as JAX's
    ``_to_grid`` lays it out. The rollout scores rank tokens, so they are
    held by their selection (the same top-9 set), the activations by the
    bf16 bound."""
    x = images(8)
    model, got, want = _push_both(micro, DTYPES["bfloat16"], x)
    assert model._gather_at_prune()
    assert (topk_sets(to_np(got.cls_token_attn), 9)
            == topk_sets(to_np(want.cls_token_attn), 9))

    assert_bf16_bound(got.proto_acts, want.proto_acts)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert torch.equal(out.cls_token_attn, got.cls_token_attn)
    # the activations are the eval forward's distances, in the same grid
    assert torch.equal(
        got.proto_acts,
        torch.log((out.distances + 1.0) / (out.distances + PP.epsilon)))


def test_serving_engine_push_forward_matches_the_model(micro):
    imgs = (np.random.default_rng(9).uniform(size=(5, 32, 32, 3))
            * 255).astype(np.uint8)
    sd = state_dict_from_jax(micro, "deit", BK.depth, 3)
    engine = ServingEngine(*port_configs(BK, PP), sd, batch_size=2,
                           compute_dtype=torch.float32, device="cpu")
    res = engine.push_forward(imgs)
    served = engine(imgs)
    assert res.proto_acts.shape == (5, 40, 3, 3)
    assert res.cls_token_attn.shape == (5, 16)
    want = jax.jit(lambda p, im: j_construct(BK, PP).apply(
        {"params": p}, im, method=JaxPPNet.push_forward))(
        micro, jnp.asarray(_normalize(imgs)))
    np.testing.assert_allclose(res.proto_acts, to_np(want.proto_acts),
                               atol=1e-4, rtol=1e-4)
    assert served.logits.shape == (5, 4)


def _normalize(imgs):
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return ((imgs.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)


# --- BaseNet ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def basenet():
    model = JaxBaseNet(BK, num_classes=5)
    params = model.init(jax.random.key(6), jnp.zeros((1, 32, 32, 3)))
    return model, params["params"]


def test_basenet_matches_jax(basenet):
    j_model, params = basenet
    x = images(10)
    want, none = j_model.apply({"params": params}, jnp.asarray(x))
    want_maps = j_model.apply({"params": params}, jnp.asarray(x),
                              method=JaxBaseNet.push_forward)
    model = construct_basenet(port_configs(BK, PP)[0], num_classes=5,
                              device="cpu")
    model.load_state_dict(
        basenet_state_dict_from_jax(params, "deit", BK.depth), strict=True)
    with torch.inference_mode():
        got, got_none = model(torch.from_numpy(x))
        maps = model.push_forward(torch.from_numpy(x))
    assert none is None and got_none is None
    assert got.shape == (4, 5) and maps.shape == (4, 24, 4, 4)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(maps), to_np(want_maps), atol=1e-4)


def test_basenet_trains_through_the_headloop():
    """Training mode differentiates the no-policy headloop: gradients
    reach the first block's qkv."""
    model = construct_basenet(port_configs(BK, PP)[0], num_classes=5,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu").train()
    logits, _ = model(torch.from_numpy(images(11)),
                      torch.Generator().manual_seed(1))
    logits.sum().backward()
    grad = model.features.blocks[0].attn.qkv.weight.grad
    assert grad is not None and float(grad.abs().sum()) > 0


# --- DeiT-S/B at width: parameter shapes -------------------------------------------

def _jax_shapes(model, img):
    tree = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                             jnp.zeros((1, img, img, 3))))
    return tree["params"]


def _zeros_like_tree(tree):
    """Shapes -> broadcast zero arrays (views: no memory per entry)."""
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        tree)


@pytest.mark.parametrize("preset", [
    "deit_small_patch16_224", "deit_base_patch16_224",
])
def test_ppnet_parameter_shapes_at_width(preset):
    """The CUB head over DeiT-S/B: the port's parameters, built on the meta
    device, have the shapes the converter gives JAX's (``jax.eval_shape``
    of its init). No forward at this width runs on the CPU."""
    j_bk = backbone_preset(preset)
    pp = PPNetConfig()
    want = state_dict_from_jax(
        _zeros_like_tree(_jax_shapes(j_construct(j_bk, pp), 224)),
        "deit", j_bk.depth)
    with torch.device("meta"):
        model = t_construct(*port_configs(j_bk, pp))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    heads = j_bk.num_heads
    assert model.features.blocks[0].attn.num_heads == heads
    assert model.add_on_layers[0].weight.shape == (192, j_bk.embed_dim, 1, 1)


@pytest.mark.parametrize("preset", [
    "deit_small_distilled_patch16_224", "deit_base_distilled_patch16_224",
])
def test_distilled_parameter_shapes_at_width(preset):
    j_bk = backbone_preset(preset)
    want = deit_state_dict_from_jax(
        _zeros_like_tree(_jax_shapes(JaxDistilled(j_bk), 224)), j_bk.depth)
    with torch.device("meta"):
        model = create_backbone(port_configs(j_bk, PP)[0])
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert model.pos_embed.shape == (1, 198, j_bk.embed_dim)


def test_head_dim_64_presets_pass_the_kernel_checks():
    """DeiT-S (6 heads) and DeiT-B (12 heads) both have head dim 64, which
    the attention kernels take."""
    from protopformer_tpu_torch.kernels.attention_core import _check_qkv

    for preset, heads in (("deit_small_patch16_224", 6),
                          ("deit_base_patch16_224", 12)):
        bk = t_config.backbone_preset(preset)
        assert bk.num_heads == heads and bk.embed_dim // heads == 64
        qkv = torch.empty((1, 197, 3 * bk.embed_dim), dtype=torch.bfloat16)
        assert _check_qkv("K1", qkv, heads, (torch.bfloat16,)) == (
            1, 197, bk.embed_dim)


# --- the kernel structure stays the default -------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_default_gates_take_the_kernel_structure(monkeypatch, micro, dtype):
    """``use_pallas="auto"`` never runs the headloop in an eval forward:
    the kernel entry points take every block (their plain versions here;
    ``test_torch_isolation.py`` holds that a failing kernel raises)."""
    headloop = []
    real = t_layers.Attention._headloop
    monkeypatch.setattr(t_layers.Attention, "_headloop",
                        lambda *a, **k: headloop.append(1) or real(*a, **k))
    calls = spy_kernels(monkeypatch)
    model = port_model(BK, PP, micro, dtype)
    x = torch.from_numpy(images(19))
    with torch.inference_mode():
        model(x)
    assert not headloop
    if dtype == torch.bfloat16:
        assert calls["fused_attention_block_stats"] == 2
    else:
        assert calls["fused_map_stats"] == 2
    assert calls["fused_attention_mean_padded"] >= 1


def test_construct_helpers_seed_reproducibly():
    bk = port_configs(BK, PP)[0]
    a = construct_distilled_deit(dataclasses.replace(bk, distilled=True),
                                 num_classes=5, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    b = construct_distilled_deit(dataclasses.replace(bk, distilled=True),
                                 num_classes=5, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    assert not a.training
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert float(a.dist_token.detach().abs().sum()) > 0
