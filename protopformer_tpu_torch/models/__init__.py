from protopformer_tpu_torch.models.deit import DeiTBackbone
from protopformer_tpu_torch.models.ppnet import (
    EvalOutput,
    PPNet,
    construct_ppnet,
)
from protopformer_tpu_torch.models.registry import (
    BACKBONE_REGISTRY,
    create_backbone,
)

__all__ = [
    "BACKBONE_REGISTRY",
    "DeiTBackbone",
    "EvalOutput",
    "PPNet",
    "construct_ppnet",
    "create_backbone",
]
