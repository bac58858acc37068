"""Reference-layout ``.pth`` files: load, resize, ingest and export (port of
``protopformer_tpu/checkpoint/torch_convert.py``).

The port's modules carry the reference PyTorch names (timm's DeiT/CaiT
keys under ``features.``, ``add_on_layers.{2j}``, ``prototype_vectors``,
``ones``, ``last_layer``...), so a reference or timm state dict loads into
them with ``load_state_dict(strict=True)`` as it is. The JAX package's
``convert_{deit,cait,ppnet}_state_dict`` (timm layout -> flax trees) and
``export_{deit,cait}_state_dict`` (the inverse) are therefore the identity
here and have no port; what remains is

  * ``load_torch_checkpoint``: deserialize, unwrap ``{"model": ...}``,
    strip DataParallel's ``module.`` prefix;
  * ``resize_pos_embed``: the position embedding's grid resized for
    another input size;
  * ``load_pretrained_backbone``: the ``--pretrained_ckpt`` path;
  * ``export_ppnet_state_dict`` and ``save_torch_checkpoint``: a PPNet as
    the reference-loadable ``.pth`` the JAX package's export writes.
"""

from __future__ import annotations

import pickle
import warnings
from typing import Dict, Mapping, Union

import torch
import torch.nn.functional as F

from protopformer_tpu_torch.checkpoint.pretrained import resolve_pretrained
from protopformer_tpu_torch.core.device import resolve_device
from protopformer_tpu_torch.models.registry import create_backbone


def load_file(path: str):
    """``torch.load`` on the CPU: tensors and plain containers only
    (``weights_only=True``); a file that needs more (the reference saves
    its ``argparse.Namespace`` under ``args``) is unpickled in full, with a
    warning, as the JAX package's ``--resume`` of a ``.pth`` does."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        warnings.warn(f"{path} holds more than tensors; unpickling it in "
                      "full: load only checkpoints you trust")
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's flat state dict of CPU tensors
    (``state_dict_of(load_file(path))``)."""
    return state_dict_of(load_file(path))


def state_dict_of(obj) -> Dict[str, torch.Tensor]:
    """A loaded checkpoint's flat state dict. Handles the reference's
    wrapping conventions: a top-level ``model`` key (timm checkpoints and
    the reference's own saves, main.py:439-441) and ``module.``-prefixed
    keys from DataParallel (ref: tools/cait_models_attn.py:348-354);
    non-tensor entries are dropped."""
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k.replace("module.", ""): v for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def resize_pos_embed(pos_embed: torch.Tensor, new_num_patches: int,
                     num_prefix_tokens: int = 1) -> torch.Tensor:
    """Bicubic position-embedding resize for another input size (ref:
    tools/deit_features.py:40-58, dead code there; the JAX package's
    ``jax.image.resize(..., "bicubic")`` is the live contract).

    That resize is Keys' cubic with a = -0.5 that antialiases when it
    shrinks; ``F.interpolate``'s bicubic is a = -0.75 and computes another
    function, except with ``antialias=True``, whose kernel is the a = -0.5
    one, scaled when shrinking. (1, prefix + N, D) -> (1, prefix + N', D)
    in fp32; the prefix tokens pass through."""
    prefix = pos_embed[:, :num_prefix_tokens]
    grid = pos_embed[0, num_prefix_tokens:].float()
    g_old = int(round(grid.shape[0] ** 0.5))
    g_new = int(round(new_num_patches ** 0.5))
    if g_old == g_new:
        return pos_embed
    grid = grid.reshape(g_old, g_old, -1).permute(2, 0, 1)[None]
    resized = F.interpolate(grid, size=(g_new, g_new), mode="bicubic",
                            align_corners=False, antialias=True)
    resized = resized[0].permute(1, 2, 0).reshape(1, g_new * g_new, -1)
    return torch.cat([prefix.float(), resized], dim=1)


def load_pretrained_backbone(path: str, backbone_cfg, device="cuda"
                             ) -> torch.nn.Module:
    """The ``--pretrained_ckpt`` path: resolve a registered name, URL or
    local path (``checkpoint/pretrained.py``), load the timm/FB ``.pth``
    (``{"model": ...}`` and ``module.`` unwrapped), resize a DeiT
    position embedding to the configured grid (a distilled file has two
    prefix tokens), and load it strictly into ``create_backbone(cfg)`` on
    ``device`` (CUDA unless the caller asks for the CPU). A plain backbone
    has no classifier: the file's ``head.*`` and ``head_dist.*`` are
    dropped, as the reference deletes its head (deit_models_attn.py:97); a
    ``DistilledDeiT`` keeps its two heads."""
    dev = resolve_device(device)
    sd = load_torch_checkpoint(resolve_pretrained(path))
    if not backbone_cfg.distilled:
        sd = {k: v for k, v in sd.items()
              if not k.startswith(("head.", "head_dist."))}
    if backbone_cfg.arch == "deit":
        sd["pos_embed"] = resize_pos_embed(
            sd["pos_embed"], backbone_cfg.num_patches,
            2 if "dist_token" in sd else 1)
    model = create_backbone(backbone_cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(dev)


def export_ppnet_state_dict(
    model_or_state_dict: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
    global_proto_per_class: int = 10,
) -> Dict[str, torch.Tensor]:
    """A PPNet (or its state dict) -> the reference-layout state dict, fp32
    on the CPU: key for key and value for value what the JAX package's
    ``export_ppnet_state_dict`` emits for the same weights. The reference
    model always registers ``ones`` and ``last_layer_global.weight``
    (ref: protopformer.py:123-131); the port's PPNet does too. With no
    global branch the JAX export writes the frozen class-identity pattern
    for ``global_proto_per_class`` prototypes a class (+1 / -0.5; the JAX
    CLI keeps the default 10), and so does this one."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    out = {k: v.detach().to("cpu", torch.float32).clone()
           for k, v in sd.items()}
    if "prototype_vectors_global" not in out:
        num_classes = out["last_layer.weight"].shape[0]
        n_global = num_classes * global_proto_per_class
        w = torch.full((num_classes, n_global), -0.5)
        j = torch.arange(n_global)
        w[j // global_proto_per_class, j] = 1.0
        out["last_layer_global.weight"] = w
    return out


def save_torch_checkpoint(path: str, sd: Mapping[str, torch.Tensor]) -> None:
    """Write a state dict as a reference-loadable ``.pth``: fp32 CPU
    tensors in the ``{"model": ...}`` convention (ref: main.py:439-441)."""
    torch.save({"model": {k: torch.as_tensor(v).detach().to(
        "cpu", torch.float32).contiguous() for k, v in sd.items()}}, path)
