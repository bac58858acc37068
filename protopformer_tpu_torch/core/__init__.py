from protopformer_tpu_torch.core.config import (
    BACKBONE_PRESETS,
    PORT_PRESETS,
    BackboneConfig,
    DataConfig,
    DINOv2Config,
    ExperimentConfig,
    OptimConfig,
    PPNetConfig,
    TrainConfig,
    backbone_preset,
)

__all__ = [
    "BACKBONE_PRESETS",
    "PORT_PRESETS",
    "BackboneConfig",
    "DataConfig",
    "DINOv2Config",
    "ExperimentConfig",
    "OptimConfig",
    "PPNetConfig",
    "TrainConfig",
    "backbone_preset",
]
