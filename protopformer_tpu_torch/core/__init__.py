from protopformer_tpu_torch.core.config import (
    BACKBONE_PRESETS,
    BackboneConfig,
    DataConfig,
    ExperimentConfig,
    OptimConfig,
    PPNetConfig,
    TrainConfig,
    backbone_preset,
)

__all__ = [
    "BACKBONE_PRESETS",
    "BackboneConfig",
    "DataConfig",
    "ExperimentConfig",
    "OptimConfig",
    "PPNetConfig",
    "TrainConfig",
    "backbone_preset",
]
