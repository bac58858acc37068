from protopformer_tpu_torch.checkpoint.convert import (
    basenet_state_dict_from_jax,
    deit_state_dict_from_jax,
    state_dict_from_jax,
)
from protopformer_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    load_params,
    save_params,
)
from protopformer_tpu_torch.checkpoint.pretrained import (
    PRETRAINED_URLS,
    cached_path,
    resolve_pretrained,
)
from protopformer_tpu_torch.checkpoint.torch_convert import (
    export_ppnet_state_dict,
    load_pretrained_backbone,
    load_torch_checkpoint,
    resize_pos_embed,
    save_torch_checkpoint,
)

__all__ = [
    "PRETRAINED_URLS",
    "CheckpointManager",
    "basenet_state_dict_from_jax",
    "cached_path",
    "deit_state_dict_from_jax",
    "export_ppnet_state_dict",
    "load_params",
    "load_pretrained_backbone",
    "load_torch_checkpoint",
    "resize_pos_embed",
    "resolve_pretrained",
    "save_params",
    "save_torch_checkpoint",
    "state_dict_from_jax",
]
