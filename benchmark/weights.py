"""Seeded weights and inputs, made on the device from the run's seed.

The state dict is in the reference PyTorch layout that both the program
and the plain reference read. Its random entries come from three large
draws of one ``torch.Generator`` on the device: one uniform draw shared by
every linear and conv (U(+-1/sqrt(fan_in)), PyTorch's default bound) and
the prototypes (U(0, 1)), and one normal draw for the CLS token and the
position embedding (N(0, 0.02^2)); LayerNorms start at ones and zeros, and
the class-identity heads and ``ones`` are fixed. Images are uint8 drawn on
the device and fetched to the host once, as the host arrays a client
sends.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Entry = Tuple[str, Tuple[int, ...], str]


def layout(cfg: dict) -> List[Entry]:
    """(key, shape, init) of every state-dict entry of a PPNet over a DeiT
    backbone; ``cfg`` as ``reference.ppnet.model_cfg`` gives it."""
    C, p, D = cfg["embed_dim"], cfg["patch_size"], cfg["proto_dim"]
    hidden = int(C * cfg["mlp_ratio"])
    n = (cfg["img_size"] // p) ** 2 + 1
    P, classes = cfg["num_prototypes"], cfg["num_classes"]
    Pg = classes * cfg["global_proto_per_class"]
    f = "features."
    out: List[Entry] = [
        (f + "patch_embed.proj.weight", (C, 3, p, p), "linear"),
        (f + "patch_embed.proj.bias", (C,), "linear_bias"),
        (f + "cls_token", (1, 1, C), "normal"),
        (f + "pos_embed", (1, n, C), "normal"),
    ]
    for i in range(cfg["depth"]):
        b = f"{f}blocks.{i}."
        for name, shape in (("attn.qkv", (3 * C, C)), ("attn.proj", (C, C)),
                            ("mlp.fc1", (hidden, C)), ("mlp.fc2", (C, hidden))):
            out.append((b + name + ".weight", shape, "linear"))
            out.append((b + name + ".bias", shape[:1], "linear_bias"))
        for norm in ("norm1", "norm2"):
            out.append((b + norm + ".weight", (C,), "ones"))
            out.append((b + norm + ".bias", (C,), "zeros"))
    out += [
        (f + "norm.weight", (C,), "ones"),
        (f + "norm.bias", (C,), "zeros"),
        ("add_on_layers.0.weight", (D, C, 1, 1), "linear"),
        ("add_on_layers.0.bias", (D,), "linear_bias"),
        ("prototype_vectors", (P, D, 1, 1), "rand01"),
        ("prototype_vectors_global", (Pg, D, 1, 1), "rand01"),
        ("ones", (P, D, 1, 1), "ones"),
        ("last_layer.weight", (classes, P), "identity"),
        ("last_layer_global.weight", (classes, Pg), "identity"),
    ]
    return out


def class_identity(classes: int, protos: int, incorrect: float,
                   device) -> torch.Tensor:
    """+1 from a class to its own prototypes, ``incorrect`` elsewhere."""
    w = torch.full((classes, protos), incorrect, device=device)
    j = torch.arange(protos, device=device)
    w[j // (protos // classes), j] = 1.0
    return w


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run's draws (weights,
    images, batches, ...), so that no two streams share their draws."""
    tag = int.from_bytes(stream.encode(), "little")
    return int(np.random.SeedSequence([seed % 2 ** 64, tag])
               .generate_state(1, np.uint64)[0] >> 1)


def state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights of ``layout(cfg)`` on ``device``, from ``seed``."""
    entries = layout(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    numel = {k: int(np.prod(shape)) for k, shape, _ in entries}
    n_uniform = sum(numel[k] for k, _, kind in entries
                    if kind in ("linear", "linear_bias", "rand01"))
    n_normal = sum(numel[k] for k, _, kind in entries if kind == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    fan_in = {}
    out, iu, inn = {}, 0, 0
    for key, shape, kind in entries:
        k = numel[key]
        if kind in ("linear", "linear_bias", "rand01"):
            u = uniform[iu:iu + k].view(shape)
            iu += k
            if kind == "rand01":
                out[key] = u
                continue
            layer = key.rsplit(".", 1)[0]
            if kind == "linear":
                fan_in[layer] = k // shape[0]
            out[key] = (u * 2.0 - 1.0) * fan_in[layer] ** -0.5
        elif kind == "normal":
            out[key] = normal[inn:inn + k].view(shape) * 0.02
            inn += k
        elif kind == "ones":
            out[key] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[key] = torch.zeros(shape, device=device)
        else:
            out[key] = class_identity(shape[0], shape[1],
                                      cfg["incorrect_class_connection"],
                                      device)
    return out


def uint8_images(count: int, size: int, seed: int, device) -> np.ndarray:
    """(count, size, size, 3) uint8 host array drawn on ``device`` from
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "images"))
    imgs = torch.randint(0, 256, (count, size, size, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    return imgs.cpu().numpy()
