from protopformer_tpu_torch.models.cait import CaiTBackbone
from protopformer_tpu_torch.models.deit import DeiTBackbone
from protopformer_tpu_torch.models.ppnet import (
    EvalOutput,
    PPNet,
    TrainOutput,
    construct_ppnet,
)
from protopformer_tpu_torch.models.registry import (
    BACKBONE_REGISTRY,
    create_backbone,
)

__all__ = [
    "BACKBONE_REGISTRY",
    "CaiTBackbone",
    "DeiTBackbone",
    "EvalOutput",
    "PPNet",
    "TrainOutput",
    "construct_ppnet",
    "create_backbone",
]
