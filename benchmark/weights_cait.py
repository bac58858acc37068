"""Seeded weights of a PPNet over a CaiT backbone, in the keys the
program's ``CaiTBackbone`` and ``PPNet`` load strictly.

The draws are ``weights.py``'s own code (a private copy of the module, run
over this file's ``layout``): the same streams from the same sub-seed, the
linears U(+-1/sqrt(fan_in)), the prototypes U(0, 1), the CLS token and the
position embedding (the patches' only) N(0, 0.02^2). Two departures, both
listed under ``assumed`` in the configuration file:

  * the LayerScale gammas come from the uniform stream (U(0, 1)), not at
    ``init_scale``: at 1e-5 every block stays near the identity, and the
    comparison would not see an error in the attention;
  * the biases of the talking-heads mixes ``proj_l`` and ``proj_w`` are
    zero: a default bias of up to 1/sqrt(num_heads) swamps mixed
    probabilities of about 1/N.

Images are ``weights.uint8_images``.
"""

from __future__ import annotations

from typing import List

from benchmark import harness
from benchmark.weights import Entry, sub_seed, uint8_images  # noqa: F401

_DRAWS = harness.load_module(harness.BENCH / "weights.py")


def _linear(key: str, out_dim: int, in_dim: int, bias: bool = True,
            bias_kind: str = "linear_bias") -> List[Entry]:
    entries = [(key + ".weight", (out_dim, in_dim), "linear")]
    if bias:
        entries.append((key + ".bias", (out_dim,), bias_kind))
    return entries


def _norm(key: str, dim: int) -> List[Entry]:
    return [(key + ".weight", (dim,), "ones"), (key + ".bias", (dim,), "zeros")]


def layout(cfg: dict) -> List[Entry]:
    """(key, shape, init) of every state-dict entry of a PPNet over a CaiT
    backbone; ``cfg`` as ``harness.model_cfg`` gives it."""
    C, p, D = cfg["embed_dim"], cfg["patch_size"], cfg["proto_dim"]
    H, qkv_bias = cfg["num_heads"], cfg["qkv_bias"]
    hidden = int(C * cfg["mlp_ratio"])
    hidden_cls = int(C * cfg["mlp_ratio_token_only"])
    patches = (cfg["img_size"] // p) ** 2
    P, classes = cfg["num_prototypes"], cfg["num_classes"]
    Pg = classes * cfg["global_proto_per_class"]
    f = "features."
    out: List[Entry] = [
        (f + "patch_embed.proj.weight", (C, 3, p, p), "linear"),
        (f + "patch_embed.proj.bias", (C,), "linear_bias"),
        (f + "cls_token", (1, 1, C), "normal"),
        (f + "pos_embed", (1, patches, C), "normal"),
    ]
    for i in range(cfg["depth"]):
        b = f"{f}blocks.{i}."
        out += _norm(b + "norm1", C)
        out += _linear(b + "attn.qkv", 3 * C, C, qkv_bias)
        out += _linear(b + "attn.proj", C, C)
        out += _linear(b + "attn.proj_l", H, H, bias_kind="zeros")
        out += _linear(b + "attn.proj_w", H, H, bias_kind="zeros")
        out += _norm(b + "norm2", C)
        out += _linear(b + "mlp.fc1", hidden, C)
        out += _linear(b + "mlp.fc2", C, hidden)
        out += [(b + "gamma_1", (C,), "rand01"), (b + "gamma_2", (C,), "rand01")]
    for i in range(cfg["depth_token_only"]):
        b = f"{f}blocks_token_only.{i}."
        out += _norm(b + "norm1", C)
        for name in ("q", "k", "v"):
            out += _linear(b + "attn." + name, C, C, qkv_bias)
        out += _linear(b + "attn.proj", C, C)
        out += _norm(b + "norm2", C)
        out += _linear(b + "mlp.fc1", hidden_cls, C)
        out += _linear(b + "mlp.fc2", C, hidden_cls)
        out += [(b + "gamma_1", (C,), "rand01"), (b + "gamma_2", (C,), "rand01")]
    out += _norm(f + "norm", C)
    out += [
        ("add_on_layers.0.weight", (D, C, 1, 1), "linear"),
        ("add_on_layers.0.bias", (D,), "linear_bias"),
        ("prototype_vectors", (P, D, 1, 1), "rand01"),
        ("prototype_vectors_global", (Pg, D, 1, 1), "rand01"),
        ("ones", (P, D, 1, 1), "ones"),
        ("last_layer.weight", (classes, P), "identity"),
        ("last_layer_global.weight", (classes, Pg), "identity"),
    ]
    return out


_DRAWS.layout = layout


def state_dict(cfg: dict, seed: int, device):
    """float32 weights of ``layout(cfg)`` on ``device``, from ``seed``,
    drawn by ``weights.state_dict``'s code."""
    return _DRAWS.state_dict(cfg, seed, device)
