"""The last configuration values and utilities of the port against the JAX
package: int8 serving (``ops/quant.py``, ``layers.QuantDense``), the
LayerNorm statistics options (``FastLayerNorm``, ``MxuLayerNorm``), the
lowering options (every ``attn_impl``, ``patch_embed="matmul"``) and
``utils/profiling.py``.

Tolerances:
  * quantization codes equal, or 1 apart at a rounding tie on at most
    0.1 % of the entries; scales equal; ``int8_matmul`` within
    1e-5 * max|out| of JAX's;
  * the JAX package's own int8 contracts on the port
    (``tests/test_quant.py``): relative error below 0.05 against the fp32
    product; the int8 model keeps at least k-2 of the fp32 model's top-k
    tokens with logits correlated above 0.98; the port's int8 model
    against JAX's int8 model: the same top-9 sets, logits within serving's
    bf16 bound (rtol 2e-2 plus 2e-2 * max|logits|);
  * the LayerNorms in bf16: each entry within one bf16 ulp of max|out| of
    JAX's, at most 1 % of the entries differing;
  * the lowering options in fp32: logits within 1e-4 and ``cls_token_attn``
    within 1e-5 of JAX's, the same top-9 sets; the ``ln_stats`` PPNets in
    bf16 by serving's bf16 bound.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.models import layers as j_layers
from protopformer_tpu.ops import quant as j_quant
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.models import construct_ppnet as t_construct
from protopformer_tpu_torch.models import layers as t_layers
from protopformer_tpu_torch.ops import quant as t_quant
from protopformer_tpu_torch.utils import profiling
from tests.torch_port import (
    assert_bf16_bound,
    assert_tie_free,
    bf16_ulp,
    jax_params,
    port_configs,
    port_model,
    to_np,
    topk_sets,
)

# test_torch_model.py's micro geometry (discard 0.7 keeps the top-9 tie-free)
BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, rollout_discard_ratio=0.7,
)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)
# tests/test_quant.py's geometry
TINY = dict(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, drop_path_rate=0.0,
)
TINY_PPNET = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)


@pytest.fixture(scope="module")
def params():
    return jax_params(BK, PP, seed=0)


def _images(seed=3, n=4):
    return np.random.default_rng(seed).normal(
        size=(n, 32, 32, 3)).astype(np.float32)


def _forward_both(backbone, params, x, dtype):
    want = jax.jit(j_construct(backbone, PP, compute_dtype=dtype).apply)(
        {"params": params}, jnp.asarray(x))
    model = port_model(backbone, PP, params,
                       torch.float32 if dtype == jnp.float32
                       else torch.bfloat16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    return got, want


# --- ops/quant.py ----------------------------------------------------------------

def _assert_codes(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("which", ["rowwise", "colwise"])
def test_quantize_matches_jax(which):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(33, 48)) * 3.7).astype(np.float32)
    x[5] = 0.0  # the 1e-12 floor
    qj, sj = getattr(j_quant, f"quantize_{which}")(jnp.asarray(x))
    qt, st = getattr(t_quant, f"quantize_{which}")(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert qt.shape == qj.shape and st.shape == sj.shape
    _assert_codes(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 40, 48)).astype(np.float32)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    want = np.asarray(j_quant.int8_matmul(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w)))
    got = t_quant.int8_matmul(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_int8_matmul_error_bound():
    """``tests/test_quant.py::test_int8_matmul_error_bound`` on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(7, 33, 48)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(48, 21)).astype(np.float32))
    got = t_quant.int8_matmul(x, w)
    want = torch.einsum("bnk,km->bnm", x, w)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 0.05, rel


def test_quantize_roundtrip_scales():
    """``tests/test_quant.py::test_quantize_roundtrip_scales`` on the port."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)) * 3.7
    q, s = t_quant.quantize_rowwise(x)
    assert q.dtype == torch.int8
    assert float((q.float() * s - x).abs().max()) <= float(s.max()) * 0.5 + 1e-6
    qw, sw = t_quant.quantize_colwise(x.T)
    assert float((qw.float() * sw - x.T).abs().max()) <= \
        float(sw.max()) * 0.5 + 1e-6


@pytest.mark.parametrize("rows,k,m", [(16, 48, 24), (40, 44, 24),
                                      (40, 48, 20)])
def test_int8_matmul_cuda_shape_rule_raises_with_its_cause(rows, k, m):
    """``torch._int_mm``'s CUDA rules (more than 16 rows, K and M multiples
    of 8) are checked before the product and name the shape; nothing is
    padded."""
    with pytest.raises(ValueError, match="multiples of 8"):
        t_quant._check_cuda_shape(rows, k, m)
    t_quant._check_cuda_shape(17, 48, 24)


def test_quant_dense_keeps_linear_keys_and_has_no_backward():
    layer = t_layers.linear(24, 72, quant=True)
    assert isinstance(layer, t_layers.QuantDense)
    assert list(layer.state_dict()) == ["weight", "bias"]
    x = torch.randn(2, 5, 24)
    with pytest.raises(RuntimeError, match="serving mode"):
        t_layers.dense(x, layer, torch.float32)
    with torch.no_grad():
        got = t_layers.dense(x, layer, torch.float32)
    want = t_quant.int8_matmul(x, layer.weight.t()) + layer.bias
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_model_same_param_tree_and_selection():
    """``tests/test_quant.py::test_int8_model_same_param_tree_and_selection``
    on the port: quantize='int8' takes the same state dict and keeps the
    top-9 close to the fp32 model's (>= k-2 overlap, logits correlated
    above 0.98)."""
    images = torch.from_numpy(np.random.default_rng(7).uniform(
        size=(3, 32, 32, 3)).astype(np.float32))
    bk, pp = port_configs(BackboneConfig(**TINY), TINY_PPNET)
    m = t_construct(bk, pp, generator=torch.Generator().manual_seed(0))
    mq = t_construct(dataclasses.replace(bk, quantize="int8"), pp,
                     torch.bfloat16)
    mq.load_state_dict(m.state_dict(), strict=True)  # identical tree
    from protopformer_tpu_torch.data.preprocess import normalize_images
    x = normalize_images(images)
    with torch.inference_mode():
        o, oq = m.eval()(x), mq.eval()(x)
    s, sq = to_np(o.cls_token_attn), to_np(oq.cls_token_attn)
    k = 9
    for a, b in zip(topk_sets(s, k), topk_sets(sq, k)):
        assert len(a & b) >= k - 2
    corr = np.corrcoef(to_np(o.logits).ravel(), to_np(oq.logits).ravel())[0, 1]
    assert corr > 0.98, corr


def test_int8_model_matches_jax_int8(params):
    """The port's int8 bf16 PPNet against JAX's on the same weights."""
    bk = dataclasses.replace(BK, quantize="int8")
    got, want = _forward_both(bk, params, _images(), jnp.bfloat16)
    want_attn = to_np(want.cls_token_attn)
    assert_tie_free(want_attn, 9)
    assert topk_sets(to_np(got.cls_token_attn), 9) == topk_sets(want_attn, 9)
    assert_bf16_bound(got.logits, want.logits)


def test_int8_serving_runs_the_kernel_structure(monkeypatch):
    """An int8 bf16 forward still takes the kernel structure: K1 on the
    pre-prune blocks and K3 after the gather (their plain versions here),
    with the products on ``int8_matmul``."""
    from tests.torch_port import spy_kernels

    calls = spy_kernels(monkeypatch)
    products = []
    real = t_layers.int8_matmul
    monkeypatch.setattr(t_layers, "int8_matmul",
                        lambda *a, **k: products.append(1) or real(*a, **k))
    bk, pp = port_configs(dataclasses.replace(BK, quantize="int8"), PP)
    model = t_construct(bk, pp, torch.bfloat16).eval()
    with torch.inference_mode():
        model(torch.from_numpy(_images(n=2)))
    assert calls["fused_attention_block_stats"] == 2
    assert calls["fused_attention_mean_padded"] == 1
    assert len(products) == 4 * BK.depth


# --- LayerNorm statistics ---------------------------------------------------------

@pytest.mark.parametrize("name", ["FastLayerNorm", "MxuLayerNorm"])
def test_layer_norm_variant_matches_jax_in_bf16(name):
    rng = np.random.default_rng(2)
    C = 192
    x = (rng.normal(size=(4, 50, C)) * 3 + 0.5).astype(np.float32)
    scale = rng.normal(size=C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = to_np(getattr(j_layers, name)(1e-6, dtype=jnp.bfloat16).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        xb))
    norm = getattr(t_layers, name)(C, eps=1e-6)
    assert list(norm.state_dict()) == ["weight", "bias"]
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = t_layers.layer_norm(torch.from_numpy(x).bfloat16(), norm,
                                  torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = to_np(got)
    # XLA keeps the normalize chain unrounded inside its fusion: the
    # statistics agree bit for bit, the chain's roundings may not
    diff = np.abs(got - want)
    assert diff.max() <= bf16_ulp(want)
    assert (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("ln_stats,dtype,cls", [
    ("compute", torch.bfloat16, "FastLayerNorm"),
    ("mxu", torch.bfloat16, "MxuLayerNorm"),
    ("compute", torch.float32, "LayerNorm"),
    ("mxu", torch.float32, "LayerNorm"),
])
def test_blocks_pick_the_layer_norm_as_jax_does(ln_stats, dtype, cls):
    """Only when ``ln_stats`` asks and the compute dtype is not fp32
    (``protopformer_tpu/models/layers.py:596-606``); the final norm stays
    a plain LayerNorm."""
    bk, pp = port_configs(dataclasses.replace(BK, ln_stats=ln_stats), PP)
    model = t_construct(bk, pp, dtype)
    for blk in model.features.blocks:
        assert type(blk.norm1).__name__ == cls
        assert type(blk.norm2).__name__ == cls
    assert type(model.features.norm) is torch.nn.LayerNorm


@pytest.mark.parametrize("ln_stats", ["compute", "mxu"])
def test_ln_stats_ppnet_matches_jax_in_bf16(params, ln_stats):
    bk = dataclasses.replace(BK, ln_stats=ln_stats)
    got, want = _forward_both(bk, params, _images(), jnp.bfloat16)
    want_attn = to_np(want.cls_token_attn)
    assert_tie_free(want_attn, 9)
    assert topk_sets(to_np(got.cls_token_attn), 9) == topk_sets(want_attn, 9)
    assert_bf16_bound(got.logits, want.logits)


# --- the lowering options -----------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("attn_impl", "headloop"), ("attn_impl", "batched"),
    ("attn_impl", "headdense"), ("attn_impl", "einsum"),
    ("patch_embed", "matmul"),
])
def test_lowering_option_matches_jax_in_fp32(params, field, value):
    """The JAX package's XLA lowering choices are one function each; the
    port runs its single implementation for every value."""
    bk = dataclasses.replace(BK, **{field: value})
    got, want = _forward_both(bk, params, _images(), jnp.float32)
    want_attn = to_np(want.cls_token_attn)
    assert_tie_free(want_attn, 9)
    assert topk_sets(to_np(got.cls_token_attn), 9) == topk_sets(want_attn, 9)
    np.testing.assert_allclose(to_np(got.cls_token_attn), want_attn,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(got.logits), to_np(want.logits),
                               atol=1e-4, rtol=1e-4)


def test_patch_embed_matmul_is_the_conv():
    """Same parameters, same function, in the conv's own layout."""
    conv = t_layers.PatchEmbed(8, 3, 24)
    mm = t_layers.PatchEmbed(8, 3, 24, impl="matmul")
    mm.load_state_dict(conv.state_dict(), strict=True)
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        torch.testing.assert_close(mm(x), conv(x), rtol=1e-5, atol=1e-5)


def test_every_backbone_value_is_accepted():
    for name, values in (("attn_impl", ("headloop", "batched", "headdense",
                                        "einsum")),
                         ("patch_embed", ("conv", "matmul")),
                         ("ln_stats", ("fp32", "compute", "mxu")),
                         ("quantize", ("off", "int8"))):
        for value in values:
            bk = t_config.backbone_preset("deit_micro_test", **{name: value})
            t_construct(bk, t_config.PPNetConfig(
                prototype_shape=(8, 16, 1, 1), num_classes=4,
                reserve_layers=(2,), reserve_token_nums=(9,),
                global_proto_per_class=2))
    assert not hasattr(t_config, "check_ported")


# --- utils/profiling.py -------------------------------------------------------------

def test_trace_writes_a_trace_holding_the_annotate_span(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.span("ppf_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ppf_span" for e in events)


def test_trace_without_a_directory_does_nothing(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
    assert os.listdir(tmp_path) == []
