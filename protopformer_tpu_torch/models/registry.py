"""Backbone registry (port of ``protopformer_tpu/models/registry.py``):
backbones are built from typed presets. Only DeiT is ported; CaiT and the
distilled DeiT raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Union

import torch

from protopformer_tpu_torch.core.config import (
    BACKBONE_PRESETS,
    BackboneConfig,
    backbone_preset,
)
from protopformer_tpu_torch.models.deit import DeiTBackbone

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
    return DeiTBackbone(cfg, compute_dtype=compute_dtype)
