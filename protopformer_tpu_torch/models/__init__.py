from protopformer_tpu_torch.models.cait import CaiTBackbone
from protopformer_tpu_torch.models.deit import (
    DeiTBackbone,
    DINOv2Backbone,
    DistilledDeiT,
    construct_distilled_deit,
)
from protopformer_tpu_torch.models.ppnet import (
    BaseNet,
    EvalOutput,
    PPNet,
    PushOutput,
    TrainOutput,
    construct_basenet,
    construct_ppnet,
)
from protopformer_tpu_torch.models.registry import (
    BACKBONE_REGISTRY,
    create_backbone,
)

__all__ = [
    "BACKBONE_REGISTRY",
    "BaseNet",
    "CaiTBackbone",
    "DeiTBackbone",
    "DINOv2Backbone",
    "DistilledDeiT",
    "EvalOutput",
    "PPNet",
    "PushOutput",
    "TrainOutput",
    "construct_basenet",
    "construct_distilled_deit",
    "construct_ppnet",
    "create_backbone",
]
