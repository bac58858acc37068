"""Backbone registry (port of ``protopformer_tpu/models/registry.py``):
backbones are built from typed presets, DeiT (``DistilledDeiT`` when the
config is distilled) or CaiT by ``arch``; any other ``arch`` raises
``ValueError``, as in the JAX package.
"""

from __future__ import annotations

from typing import Union

import torch

from protopformer_tpu_torch.core.config import (
    BACKBONE_PRESETS,
    BackboneConfig,
    backbone_preset,
)
from protopformer_tpu_torch.models.cait import CaiTBackbone
from protopformer_tpu_torch.models.deit import DeiTBackbone, DistilledDeiT

BACKBONE_REGISTRY = tuple(BACKBONE_PRESETS)


def create_backbone(
    name_or_config: Union[str, BackboneConfig],
    compute_dtype: torch.dtype = torch.float32,
    **overrides,
):
    """Build a backbone module from a preset name or an explicit config."""
    if isinstance(name_or_config, str):
        cfg = backbone_preset(name_or_config, **overrides)
    else:
        cfg = name_or_config
    if cfg.arch == "deit":
        if cfg.distilled:
            # a standalone two-head classifier, not a PPNet backbone
            return DistilledDeiT(cfg, compute_dtype=compute_dtype)
        return DeiTBackbone(cfg, compute_dtype=compute_dtype)
    if cfg.arch == "cait":
        return CaiTBackbone(cfg, compute_dtype=compute_dtype)
    raise ValueError(f"unknown backbone arch: {cfg.arch}")
