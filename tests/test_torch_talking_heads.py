"""CaiT's talking-heads region's routes (``ops/talking_heads.py``): the
hand-written kernel (``csrc/talking_heads.cu``) or the eager chain.

The route follows what the tensors show, with no option: it is followed
here on a CPU tensor that says it lies on the card, with a recording
launcher in place of the kernel library (no launch, no stream), as
``tests/test_torch_ops.py`` follows the GELU pass. The kernel against the
chain on the card is in ``tests/test_torch_gpu.py``. The file imports
neither JAX nor the JAX package.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

from protopformer_tpu_torch.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu_torch.kernels import _build
from protopformer_tpu_torch.kernels import talking_heads as kth
from protopformer_tpu_torch.models.layers import TalkingHeadAttention, _scale
from protopformer_tpu_torch.ops import talking_heads as oth
from protopformer_tpu_torch.utils import profiling

torch.set_num_threads(1)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def is_cuda(self):
        return True


class _Library:
    """The kernel library's talking-heads launcher, recording its calls."""

    def __init__(self):
        self.calls = []

    def ppf_talking_heads(self, qkv, B, N, H, scale, wl, bl, ww, bw, fusion,
                          map_fp32, out, fmap, stream):
        self.calls.append({"B": B, "N": N, "H": H, "scale": scale,
                           "biases": (bl is not None, bw is not None),
                           "fusion": fusion, "map_fp32": map_fp32})
        return 0


@pytest.fixture
def library(monkeypatch):
    """A fresh counter registry and the recording launcher in place of the
    built library."""
    lib = _Library()
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: contextlib.nullcontext(0))
    return lib


def _mixes(heads, bias=True, seed=0):
    gen = torch.Generator().manual_seed(seed)
    layers = [nn.Linear(heads, heads, bias=bias) for _ in range(2)]
    with torch.no_grad():
        for layer in layers:
            layer.weight.copy_(torch.randn((heads, heads), generator=gen))
            if bias:
                layer.bias.copy_(torch.randn((heads,), generator=gen) * 0.1)
    return layers


def _qkv(rng, B, N, heads, head_dim=48, dtype=torch.bfloat16):
    return torch.from_numpy(rng.normal(
        size=(B, N, 3 * heads * head_dim)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("on_card,dtype,heads,requires_grad,grad_mode,route", [
    (False, torch.bfloat16, 8, False, False, "cpu"),
    (False, torch.float32, 8, True, True, "cpu"),
    (True, torch.bfloat16, 8, False, True, "kernel"),
    (True, torch.bfloat16, 4, False, True, "kernel"),
    (True, torch.bfloat16, 8, True, False, "kernel"),
    (True, torch.bfloat16, 8, True, True, "plain"),
    (True, torch.float32, 8, False, False, "plain"),
    (True, torch.bfloat16, 6, False, False, "plain"),
], ids=["cpu_bf16", "cpu_fp32_grad", "card_bf16_h8", "card_bf16_h4",
        "card_bf16_no_grad_mode", "card_bf16_autograd", "card_fp32",
        "card_bf16_h6"])
def test_talking_heads_routes_by_what_the_tensors_show(
        rng, library, on_card, dtype, heads, requires_grad, grad_mode,
        route):
    """The kernel for a bf16 qkv on the card that needs no gradient (the
    mixes' weights frozen here), at 4 or 8 heads of 48: one launch counted
    ``launches.talking_heads``; else the plain chain, its outputs (and
    gradient) unchanged, counted ``talking_heads.plain`` on the card
    alone."""
    proj_l, proj_w = (m.requires_grad_(False) for m in _mixes(heads))
    qkv = _qkv(rng, 2, 9, heads, dtype=dtype)
    scale = _scale(48, dtype)
    want = oth.talking_heads_plain(qkv, heads, scale, proj_l, proj_w, "mean",
                                   torch.float32, dtype)
    if on_card:
        qkv = qkv.as_subclass(_OnCard)
    qkv.requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad_mode):
        out, fmap = oth.talking_heads(qkv, heads, scale, proj_l, proj_w,
                                      "mean", torch.float32, dtype)
    assert profiling.counts() == {
        "kernel": {"launches.talking_heads": 1},
        "plain": {"talking_heads.plain": 1}, "cpu": {}}[route]
    assert library.calls == ([{"B": 2, "N": 9, "H": heads, "scale": scale,
                               "biases": (True, True), "fusion": 0,
                               "map_fp32": 1}] if route == "kernel" else [])
    assert out.shape == (2, 9, 48 * heads) and fmap.shape == (2, 9, 9)
    assert out.dtype == dtype and fmap.dtype == torch.float32
    if route != "kernel":
        assert torch.equal(out.detach(), want[0])
        assert torch.equal(fmap, want[1])
    if requires_grad and grad_mode:
        out.float().sum().backward()
        assert qkv.grad is not None and bool(torch.isfinite(qkv.grad).all())


def test_a_mix_that_needs_a_gradient_takes_the_chain(rng, library):
    """A bf16 qkv that needs none, but a talking-heads mix whose weights
    do, under autograd: the chain, so that the mix gets its gradient."""
    proj_l, proj_w = _mixes(8)
    proj_l.requires_grad_(False)
    qkv = _qkv(rng, 1, 5, 8).as_subclass(_OnCard)
    out, _ = oth.talking_heads(qkv, 8, _scale(48, torch.bfloat16), proj_l,
                               proj_w, "mean", torch.bfloat16, torch.bfloat16)
    assert profiling.counts() == {"talking_heads.plain": 1}
    assert library.calls == []
    out.float().sum().backward()
    assert proj_w.weight.grad is not None


@pytest.mark.parametrize("fusion,map_dtype,bias", [
    ("mean", torch.bfloat16, True), ("max", torch.float32, True),
    ("min", torch.bfloat16, False)])
def test_the_kernel_gets_the_fusion_the_map_dtype_and_the_biases(
        rng, library, fusion, map_dtype, bias):
    proj_l, proj_w = _mixes(4, bias=bias)
    qkv = _qkv(rng, 3, 17, 4).as_subclass(_OnCard)
    out, fmap = kth.talking_heads_cuda(qkv, 0.25, proj_l, proj_w, fusion,
                                       map_dtype)
    assert library.calls == [{"B": 3, "N": 17, "H": 4, "scale": 0.25,
                              "biases": (bias, bias),
                              "fusion": kth.FUSIONS[fusion],
                              "map_fp32": int(map_dtype == torch.float32)}]
    assert out.shape == (3, 17, 192) and out.dtype == torch.bfloat16
    assert fmap.shape == (3, 17, 17) and fmap.dtype == map_dtype


def test_the_route_hands_the_kernel_a_contiguous_qkv(rng, library):
    proj_l, proj_w = _mixes(8)
    qkv = _qkv(rng, 6, 2, 8).transpose(0, 1).as_subclass(_OnCard)
    assert not qkv.is_contiguous()
    with torch.no_grad():
        out, _ = oth.talking_heads(qkv, 8, 0.125, proj_l, proj_w, "mean",
                                   torch.bfloat16, torch.bfloat16)
    assert out.shape == (2, 6, 384)
    assert [c["B"] for c in library.calls] == [2]


@pytest.mark.parametrize("case,error", [
    ("cpu", ValueError), ("fp32", TypeError), ("strided", ValueError),
    ("head_width_64", ValueError), ("six_heads", ValueError),
    ("fusion", ValueError), ("map_fp16", TypeError),
    ("weight_fp64", TypeError), ("weight_shape", ValueError)])
def test_the_kernel_refuses_what_it_does_not_take(rng, library, case, error):
    heads = 6 if case == "six_heads" else 8
    head_dim = 64 if case == "head_width_64" else 48
    proj_l, proj_w = _mixes(heads)
    qkv = _qkv(rng, 2, 9, heads, head_dim)
    if case != "cpu":
        qkv = qkv.as_subclass(_OnCard)
    if case == "fp32":
        qkv = qkv.float()
    if case == "strided":
        qkv = qkv.transpose(0, 1)
    if case == "weight_fp64":
        proj_w = proj_w.double()
    if case == "weight_shape":
        proj_w = nn.Linear(heads, heads + 1)
    with pytest.raises(error):
        kth.talking_heads_cuda(
            qkv, 0.125, proj_l, proj_w,
            "median" if case == "fusion" else "mean",
            torch.float16 if case == "map_fp16" else torch.bfloat16)
    assert library.calls == [] and profiling.counts() == {}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_a_bf16_block_takes_the_kernel_with_no_option(rng, library,
                                                      training):
    """``TalkingHeadAttention`` in bf16 on the card: the kernel once a
    forward with no gradient, the chain under training's autograd; nothing
    selects the route but the tensors (no config field, no argument)."""
    attn = TalkingHeadAttention(384, 8, True, torch.bfloat16).train(training)
    x = torch.from_numpy(rng.normal(size=(2, 7, 384)).astype(np.float32)).to(
        torch.bfloat16).as_subclass(_OnCard)
    with torch.set_grad_enabled(training):
        out, fmap = attn(x)
    assert out.shape == (2, 7, 384) and fmap.shape == (2, 7, 7)
    assert profiling.counts() == ({"talking_heads.plain": 1} if training
                                  else {"launches.talking_heads": 1})
    assert len(library.calls) == (0 if training else 1)
    for cfg in (BackboneConfig, PPNetConfig):
        assert not [f.name for f in dataclasses.fields(cfg)
                    if "talking" in f.name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("fusion", ["mean", "max", "min"])
def test_the_block_on_the_cpu_is_the_plain_chain(rng, dtype, fusion):
    """On the CPU a block's region is ``talking_heads_plain`` on its qkv,
    bit for bit, and the chain restated step by step gives its bits."""
    attn = TalkingHeadAttention(96, 2, True, dtype, head_fusion=fusion,
                                map_dtype=torch.bfloat16)
    with torch.no_grad():
        attn.proj_l.bias.normal_()
    x = torch.from_numpy(rng.normal(size=(2, 11, 96)).astype(np.float32))
    with torch.no_grad():
        out, fmap = attn(x)
        qkv = nn.functional.linear(x.to(dtype), attn.qkv.weight.to(dtype),
                                   attn.qkv.bias.to(dtype))
        p_out, p_map = oth.talking_heads_plain(
            qkv, 2, _scale(48, dtype), attn.proj_l, attn.proj_w, fusion,
            torch.bfloat16, dtype)
        q, k, v = qkv.reshape(2, 11, 3, 2, 48).permute(2, 0, 3, 1, 4)
        logits = torch.matmul(q * _scale(48, dtype), k.transpose(-1, -2))
        def mix(a, layer):
            return nn.functional.linear(
                a.permute(0, 2, 3, 1), layer.weight.to(dtype),
                layer.bias.to(dtype)).permute(0, 3, 1, 2)

        logits = mix(logits, attn.proj_l)
        probs = mix(torch.softmax(logits.float(), -1).to(dtype), attn.proj_w)
        fused = {"mean": probs.float().mean(1), "max": probs.float().amax(1),
                 "min": probs.float().amin(1)}[fusion]
    assert torch.equal(fmap, p_map) and torch.equal(fmap, fused.bfloat16())
    assert torch.equal(p_out, torch.matmul(probs, v).transpose(1, 2).reshape(
        2, 11, 96))
    assert torch.equal(out, nn.functional.linear(
        p_out, attn.proj.weight.to(dtype), attn.proj.bias.to(dtype)))
