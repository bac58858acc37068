from protopformer_tpu_torch.checkpoint.convert import (
    basenet_state_dict_from_jax,
    deit_state_dict_from_jax,
    state_dict_from_jax,
)

__all__ = [
    "basenet_state_dict_from_jax",
    "deit_state_dict_from_jax",
    "state_dict_from_jax",
]
