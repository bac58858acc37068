"""The data layer (port of ``protopformer_tpu/data``): normalization,
dataset indices, host transforms, the host loader, mixup/cutmix, the CUB
part annotations (``data.local_parts``) and the native image pipeline
(``data.native``). It exports what the JAX package's ``data`` exports."""

from protopformer_tpu_torch.data.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_images,
    unnormalize_images,
)
from protopformer_tpu_torch.data.datasets import (
    DatasetIndex,
    build_dataset_index,
    NUM_CLASSES,
)
from protopformer_tpu_torch.data.transforms import (
    build_eval_transform,
    build_train_transform,
    build_view_transform,
)
from protopformer_tpu_torch.data.loader import HostDataLoader
from protopformer_tpu_torch.data.mixup import MixupCutmix
