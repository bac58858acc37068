"""JAX PPNet params -> the port's (reference-layout) state dict.

The port's own converter, written to the conventions of the JAX package's
exporter (``protopformer_tpu/checkpoint/torch_convert.py:282-425``):

  flax Dense kernel (in, out)          -> Linear weight (out, in)  [.T]
  flax Conv kernel (h, w, in, out)     -> Conv2d weight (out, in, h, w)
  flax LayerNorm scale/bias            -> weight/bias
  add-on Dense layers_j                -> add_on_layers.{2j} 1x1 conv
  prototypes (P, C)                    -> (P, C, 1, 1), plus ``ones``
  frozen heads (P, cls)                -> (cls, P) [.T]

``params`` is the JAX package's nested dict of numpy arrays (any array
type ``np.asarray`` accepts); the result is a dict of fp32 CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(tree: Tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = _a(tree["kernel"]).T
    if "bias" in tree:
        out[f"{prefix}.bias"] = _a(tree["bias"])


def _layernorm(tree: Tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = _a(tree["scale"])
    out[f"{prefix}.bias"] = _a(tree["bias"])


def _deit(params: Tree, depth: int) -> Dict[str, np.ndarray]:
    sd = {"cls_token": _a(params["cls_token"]),
          "pos_embed": _a(params["pos_embed"])}
    proj = params["patch_embed"]["proj"]
    sd["patch_embed.proj.weight"] = _a(proj["kernel"]).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = _a(proj["bias"])
    _layernorm(params["norm"], "norm", sd)
    for i in range(depth):
        blk = params[f"blocks_{i}"]
        p = f"blocks.{i}"
        _layernorm(blk["norm1"], f"{p}.norm1", sd)
        _layernorm(blk["norm2"], f"{p}.norm2", sd)
        _linear(blk["attn"]["qkv"], f"{p}.attn.qkv", sd)
        _linear(blk["attn"]["proj"], f"{p}.attn.proj", sd)
        _linear(blk["mlp"]["fc1"], f"{p}.mlp.fc1", sd)
        _linear(blk["mlp"]["fc2"], f"{p}.mlp.fc2", sd)
    return sd


def state_dict_from_jax(
    params: Tree,
    arch: str,
    depth: int,
    global_proto_per_class: int = 10,
) -> Dict[str, torch.Tensor]:
    """JAX ``PPNet`` params tree -> reference-layout state dict.

    Key for key and value for value what the JAX package's
    ``export_ppnet_state_dict`` emits for a DeiT PPNet; with no global
    branch, ``last_layer_global.weight`` is synthesized at the frozen
    class-identity pattern of ``global_proto_per_class`` prototypes per
    class, as the reference model always registers it.
    """
    if arch != "deit":
        raise NotImplementedError(
            f"arch={arch!r} is not ported yet: ROADMAP.md Queue 1 item 8"
        )
    sd = {f"features.{k}": v for k, v in _deit(params["features"], depth).items()}
    add_on = params["add_on_layers"]
    for j in range(len(add_on)):
        layer = add_on[f"layers_{j}"]
        sd[f"add_on_layers.{2 * j}.weight"] = _a(layer["kernel"]).T[:, :, None, None]
        sd[f"add_on_layers.{2 * j}.bias"] = _a(layer["bias"])
    protos = _a(params["prototype_vectors"])
    sd["prototype_vectors"] = protos[:, :, None, None]
    sd["ones"] = np.ones(protos.shape + (1, 1), np.float32)
    sd["last_layer.weight"] = _a(params["last_layer_w"]).T
    if "prototype_vectors_global" in params:
        sd["prototype_vectors_global"] = _a(
            params["prototype_vectors_global"]
        )[:, :, None, None]
        sd["last_layer_global.weight"] = _a(params["last_layer_global_w"]).T
    else:
        num_classes = _a(params["last_layer_w"]).shape[1]
        n_global = num_classes * global_proto_per_class
        w = np.full((num_classes, n_global), -0.5, np.float32)
        for j in range(n_global):
            w[j // global_proto_per_class, j] = 1.0
        sd["last_layer_global.weight"] = w
    # copies: the source arrays may be read-only views of device buffers
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
