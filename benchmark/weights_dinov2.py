"""Seeded weights of a PPNet over a DINOv2 backbone with registers, in the
keys the program's ``DINOv2Backbone`` and ``PPNet`` load strictly (a
DINOv2 backbone state dict's own keys under ``features.``).

The draws are ``weights.py``'s own code (a private copy of the module, run
over this file's ``layout``): the same streams from the same sub-seed, the
linears U(+-1/sqrt(fan_in)), the prototypes U(0, 1), the CLS token, the
register tokens and the position embedding (the CLS token's and the
patches') N(0, 0.02^2). The mask token (DINOv2's masked-image-modelling
token, which the forward never reads) is zero. One departure, listed under
``assumed`` in the configuration file: the LayerScale gammas come from the
uniform stream (U(0, 1)), not at ``init_scale``.

Images are ``weights.uint8_images``.
"""

from __future__ import annotations

from typing import List

from benchmark import harness
from benchmark.weights import Entry, sub_seed, uint8_images  # noqa: F401

_DRAWS = harness.load_module(harness.BENCH / "weights.py")


def swiglu_hidden(cfg: dict) -> int:
    """DINOv2's ``SwiGLUFFNFused`` hidden width."""
    return (int(cfg["embed_dim"] * cfg["mlp_ratio"] * 2 / 3) + 7) // 8 * 8


def _linear(key: str, out_dim: int, in_dim: int) -> List[Entry]:
    return [(key + ".weight", (out_dim, in_dim), "linear"),
            (key + ".bias", (out_dim,), "linear_bias")]


def _norm(key: str, dim: int) -> List[Entry]:
    return [(key + ".weight", (dim,), "ones"), (key + ".bias", (dim,), "zeros")]


def layout(cfg: dict) -> List[Entry]:
    """(key, shape, init) of every state-dict entry of a PPNet over a
    DINOv2 backbone with registers and the SwiGLU FFN; ``cfg`` as
    ``harness.model_cfg`` gives it."""
    C, p, D = cfg["embed_dim"], cfg["patch_size"], cfg["proto_dim"]
    hidden = swiglu_hidden(cfg)
    patches = (cfg["img_size"] // p) ** 2
    P, classes = cfg["num_prototypes"], cfg["num_classes"]
    Pg = classes * cfg["global_proto_per_class"]
    f = "features."
    out: List[Entry] = [
        (f + "patch_embed.proj.weight", (C, 3, p, p), "linear"),
        (f + "patch_embed.proj.bias", (C,), "linear_bias"),
        (f + "cls_token", (1, 1, C), "normal"),
        (f + "pos_embed", (1, 1 + patches, C), "normal"),
        (f + "register_tokens", (1, cfg["num_register_tokens"], C), "normal"),
        (f + "mask_token", (1, C), "zeros"),
    ]
    for i in range(cfg["depth"]):
        b = f"{f}blocks.{i}."
        out += _norm(b + "norm1", C)
        out += _linear(b + "attn.qkv", 3 * C, C)
        out += _linear(b + "attn.proj", C, C)
        out += [(b + "ls1.gamma", (C,), "rand01")]
        out += _norm(b + "norm2", C)
        out += _linear(b + "mlp.w12", 2 * hidden, C)
        out += _linear(b + "mlp.w3", C, hidden)
        out += [(b + "ls2.gamma", (C,), "rand01")]
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
