"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: config translation, seeded JAX weights and array conversion.

Importing it also runs PyTorch's CPU ops on one thread. The suite runs
under pytest-xdist with several workers per machine; PyTorch's default of
one OpenMP thread per core then oversubscribes the cores, and its thread
barriers stall whenever another worker holds a core (a 0.8 s test was
measured at 24 s that way). One thread costs these small shapes little.

Importing it also makes JAX's CPU client run each computation inline on
the calling thread (``jax_cpu_enable_async_dispatch`` off). An eager call
of a Pallas kernel in TPU interpret mode runs the kernel body as host
callbacks that dispatch JAX ops of their own; under async dispatch the
calling thread goes on to dispatch the next op, and the two can wait on
each other for good (the exact case of ``test_models.py``'s
``test_deit_masked_forward_fused_block_stats`` hung so about once in ten
runs on a loaded 8-core CPU). The setting is process-wide and every
xdist worker imports this module while it collects, before its first
computation, so it holds for each test the worker runs."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import torch

from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.models import construct_ppnet as t_construct
from protopformer_tpu_torch.models import deit as t_deit
from protopformer_tpu_torch.models import layers as t_layers

torch.set_num_threads(1)
jax.config.update("jax_cpu_enable_async_dispatch", False)

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
        state_dict_from_jax(params, backbone.arch, backbone.depth,
                            ppnet.global_proto_per_class,
                            backbone.depth_token_only),
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


def bf16_ulp(x) -> float:
    """The bf16 ulp (2^-7 of the power of two below) at max|x|."""
    return math.ldexp(1.0, math.frexp(float(np.abs(x).max()))[1] - 8)


def assert_bf16_bound(got, want):
    """Serving's bf16 value bound: rtol 2e-2 plus 2e-2 * max|want|."""
    want = to_np(want)
    np.testing.assert_allclose(to_np(got), want, rtol=2e-2,
                               atol=2e-2 * float(np.abs(want).max()))


def images(seed, n=4, size=32):
    """Seeded normal (n, size, size, 3) fp32 NHWC images."""
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def spy_kernels(monkeypatch):
    """Count the calls of each kernel entry point that the port's layers
    and DeiT backbone make (their plain versions run on the CPU)."""
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)
        calls[name] = 0

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("fused_attention_block_stats", "fused_attention_core",
                 "fused_attention_mean_padded"):
        spy(t_layers, name)
    spy(t_deit, "fused_map_stats")
    return calls
