from protopformer_tpu_torch.checkpoint.convert import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
