"""JAX PPNet params -> the port's (reference-layout) state dict.

The port's own converter, written to the conventions of the JAX package's
exporter (``protopformer_tpu/checkpoint/torch_convert.py:282-425``):

  flax Dense kernel (in, out)          -> Linear weight (out, in)  [.T]
  flax Conv kernel (h, w, in, out)     -> Conv2d weight (out, in, h, w)
  flax LayerNorm scale/bias            -> weight/bias
  CaiT LayerScale gamma_1/gamma_2      -> as they are
  add-on Dense layers_j                -> add_on_layers.{2j} 1x1 conv
  prototypes (P, C)                    -> (P, C, 1, 1), plus ``ones``
  frozen heads (P, cls)                -> (cls, P) [.T]

``params`` is the JAX package's nested dict of numpy arrays (any array
type ``np.asarray`` accepts); the result is a dict of fp32 CPU tensors.
``state_dict_from_jax`` converts a PPNet, ``basenet_state_dict_from_jax``
a ``BaseNet`` and ``deit_state_dict_from_jax`` a bare DeiT backbone or
``DistilledDeiT``.
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


def _embed(params: Tree) -> Dict[str, np.ndarray]:
    """CLS token, position embedding, patch-embed conv and final norm."""
    sd = {"cls_token": _a(params["cls_token"]),
          "pos_embed": _a(params["pos_embed"])}
    proj = params["patch_embed"]["proj"]
    sd["patch_embed.proj.weight"] = _a(proj["kernel"]).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = _a(proj["bias"])
    _layernorm(params["norm"], "norm", sd)
    return sd


def _block(blk: Tree, p: str, attn_linears, out: Dict[str, np.ndarray]
           ) -> None:
    """One block's LayerScale gammas (CaiT), norms, attention and MLP."""
    for gamma in ("gamma_1", "gamma_2"):
        if gamma in blk:
            out[f"{p}.{gamma}"] = _a(blk[gamma])
    _layernorm(blk["norm1"], f"{p}.norm1", out)
    _layernorm(blk["norm2"], f"{p}.norm2", out)
    for lin in attn_linears:
        _linear(blk["attn"][lin], f"{p}.attn.{lin}", out)
    _linear(blk["mlp"]["fc1"], f"{p}.mlp.fc1", out)
    _linear(blk["mlp"]["fc2"], f"{p}.mlp.fc2", out)


def _deit(params: Tree, depth: int) -> Dict[str, np.ndarray]:
    """A DeiT backbone; a distilled one adds its token and two heads."""
    sd = _embed(params)
    if "dist_token" in params:
        sd["dist_token"] = _a(params["dist_token"])
    for head in ("head", "head_dist"):
        if head in params:
            _linear(params[head], head, sd)
    for i in range(depth):
        _block(params[f"blocks_{i}"], f"blocks.{i}", ("qkv", "proj"), sd)
    return sd


def _features(params: Tree, arch: str, depth: int, depth_token_only: int
              ) -> Dict[str, np.ndarray]:
    if arch == "deit":
        return _deit(params, depth)
    if arch == "cait":
        return _cait(params, depth, depth_token_only)
    raise ValueError(f"unknown backbone arch: {arch}")


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # copies: the source arrays may be read-only views of device buffers
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def deit_state_dict_from_jax(params: Tree, depth: int
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``DeiTBackbone`` or ``DistilledDeiT`` params -> timm-layout
    state dict, key for key and value for value what the JAX package's
    ``export_deit_state_dict`` emits (``dist_token``, ``head`` and
    ``head_dist`` when the tree has them)."""
    return _tensors(_deit(params, depth))


def basenet_state_dict_from_jax(
    params: Tree, arch: str, depth: int, depth_token_only: int = 2
) -> Dict[str, torch.Tensor]:
    """JAX ``BaseNet`` params -> the reference layout: ``features.*`` and
    the linear head ``last_layer.weight``/``.bias``."""
    sd = {f"features.{k}": v for k, v in
          _features(params["features"], arch, depth, depth_token_only).items()}
    _linear(params["last_layer"], "last_layer", sd)
    return _tensors(sd)


def _cait(params: Tree, depth: int, depth_token_only: int
          ) -> Dict[str, np.ndarray]:
    """Talking heads' ``proj_l``/``proj_w`` are Linear(H, H); the
    class-attention blocks keep separate q/k/v."""
    sd = _embed(params)
    for i in range(depth):
        _block(params[f"blocks_{i}"], f"blocks.{i}",
               ("qkv", "proj", "proj_l", "proj_w"), sd)
    for i in range(depth_token_only):
        _block(params[f"blocks_token_only_{i}"], f"blocks_token_only.{i}",
               ("q", "k", "v", "proj"), sd)
    return sd


def state_dict_from_jax(
    params: Tree,
    arch: str,
    depth: int,
    global_proto_per_class: int = 10,
    depth_token_only: int = 2,
) -> Dict[str, torch.Tensor]:
    """JAX ``PPNet`` params tree -> reference-layout state dict.

    Key for key and value for value what the JAX package's
    ``export_ppnet_state_dict`` emits for a DeiT or CaiT PPNet (``arch``;
    CaiT with ``depth_token_only`` class-attention blocks), with either
    add-on stack ("regular" or "bottleneck": Dense ``layers_j`` becomes the
    1x1 conv at Sequential index 2j); with no global
    branch, ``last_layer_global.weight`` is synthesized at the frozen
    class-identity pattern of ``global_proto_per_class`` prototypes per
    class, as the reference model always registers it.
    """
    feats = _features(params["features"], arch, depth, depth_token_only)
    sd = {f"features.{k}": v for k, v in feats.items()}
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
    return _tensors(sd)
