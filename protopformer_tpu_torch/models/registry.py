"""Backbone registry (port of ``protopformer_tpu/models/registry.py``):
backbones are built from typed presets, DeiT (``DistilledDeiT`` when the
config is distilled) or CaiT by ``arch``, as in the JAX package, and the
port's own DINOv2 (``arch="dinov2"``, a ``DINOv2Config``); any other
``arch`` raises ``ValueError``.
"""

from __future__ import annotations

from typing import Union

import torch

from protopformer_tpu_torch.core.config import (
    BACKBONE_PRESETS,
    BackboneConfig,
    DINOv2Config,
    backbone_preset,
)
from protopformer_tpu_torch.models.cait import CaiTBackbone
from protopformer_tpu_torch.models.deit import (
    DeiTBackbone,
    DINOv2Backbone,
    DistilledDeiT,
)

BACKBONE_REGISTRY = tuple(BACKBONE_PRESETS)  # the JAX package's presets


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
    if cfg.arch == "dinov2":
        if not isinstance(cfg, DINOv2Config):
            raise ValueError("arch 'dinov2' needs a DINOv2Config (its "
                             "registers and FFN)")
        return DINOv2Backbone(cfg, compute_dtype=compute_dtype)
    raise ValueError(f"unknown backbone arch: {cfg.arch}")
