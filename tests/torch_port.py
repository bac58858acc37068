"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: config translation, seeded JAX weights and array conversion.

Importing it also runs PyTorch's CPU ops on one thread. The suite runs
under pytest-xdist with several workers per machine; PyTorch's default of
one OpenMP thread per core then oversubscribes the cores, and its thread
barriers stall whenever another worker holds a core (a 0.8 s test was
measured at 24 s that way). One thread costs these small shapes little."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.models import construct_ppnet as t_construct

torch.set_num_threads(1)

# the kernel gates keep the port's own default ("auto": the kernel-on
# structure); every other field takes the JAX config's value
_PORT_DEFAULTS = ("use_pallas", "stats_kernel")


def port_configs(backbone, ppnet):
    """JAX (BackboneConfig, PPNetConfig) -> the port's, field for field."""
    return (
        t_config.BackboneConfig(**{
            f.name: getattr(backbone, f.name)
            for f in dataclasses.fields(t_config.BackboneConfig)
            if f.name not in _PORT_DEFAULTS
        }),
        t_config.PPNetConfig(**dataclasses.asdict(ppnet)),
    )


def jax_params(backbone, ppnet, seed):
    """Seeded flax init of the JAX PPNet, as nested dicts of numpy arrays."""
    model = j_construct(backbone, ppnet)
    img = backbone.img_size
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, img, img, 3))))
    return jax.tree.map(np.asarray, init(jax.random.key(seed))["params"])


def port_model(backbone, ppnet, params, compute_dtype=torch.float32):
    """The port's PPNet on the CPU with the JAX weights, in eval mode."""
    model = t_construct(*port_configs(backbone, ppnet), compute_dtype)
    model.load_state_dict(
        state_dict_from_jax(params, "deit", backbone.depth,
                            ppnet.global_proto_per_class),
        strict=True,
    )
    return model.eval()


def to_np(x):
    """JAX array or torch tensor -> numpy, bf16 widened to fp32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def topk_sets(scores, k):
    return [set(row.tolist()) for row in np.argsort(-scores, axis=-1)[:, :k]]


def assert_tie_free(scores, k):
    """The k-th and (k+1)-th largest score of every row differ, so the
    top-k set does not depend on how ties are broken."""
    s = -np.sort(-scores, axis=-1)
    gap = s[:, k - 1] - s[:, k]
    assert (gap > 0).all(), f"tied top-{k} boundary: gaps {gap}"
