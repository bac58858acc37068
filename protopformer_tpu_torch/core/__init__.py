from protopformer_tpu_torch.core.config import (
    BACKBONE_PRESETS,
    BackboneConfig,
    PPNetConfig,
    backbone_preset,
    check_ported,
)

__all__ = [
    "BACKBONE_PRESETS",
    "BackboneConfig",
    "PPNetConfig",
    "backbone_preset",
    "check_ported",
]
