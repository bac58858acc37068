"""Weights carried from the JAX package into the PyTorch port.

``state_dict_from_jax`` must emit exactly what the JAX package's
``export_ppnet_state_dict`` emits (the reference PyTorch layout), and the
port's ``PPNet`` must take it with ``load_state_dict(strict=True)``. The
port's normalization fold must agree with the JAX one within 1e-6.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.checkpoint.torch_convert import export_ppnet_state_dict
from protopformer_tpu.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu.data import preprocess as j_pre
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.data import preprocess as t_pre
from protopformer_tpu_torch.models import construct_ppnet as t_construct
from tests.torch_port import jax_params, port_configs

BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2,
)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)


@pytest.mark.parametrize("use_global", [True, False])
def test_state_dict_from_jax_equals_export_and_loads_strict(use_global):
    pp = dataclasses.replace(PP, use_global=use_global)
    params = jax_params(BK, pp, seed=3)
    want = export_ppnet_state_dict(params, "deit", BK.depth,
                                   global_proto_per_class=3)
    got = state_dict_from_jax(params, "deit", BK.depth,
                              global_proto_per_class=3)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)

    model = t_construct(*port_configs(BK, pp))
    model.load_state_dict(got, strict=True)
    assert model.prototype_vectors.shape == (40, 16, 1, 1)
    assert model.add_on_layers[0].weight.shape == (16, 24, 1, 1)
    assert model.features.blocks[0].attn.qkv.weight.shape == (72, 24)


def test_state_dict_from_jax_rejects_cait():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        state_dict_from_jax({}, "cait", 3)


@pytest.mark.parametrize("input_scale", [1.0, 1.0 / 255.0])
def test_fold_normalization_matches_jax(input_scale):
    params = jax_params(BK, PP, seed=5)
    sd = state_dict_from_jax(params, "deit", BK.depth,
                             global_proto_per_class=3)
    want = export_ppnet_state_dict(
        j_pre.fold_normalization_into_patch_embed(
            params, input_scale=input_scale
        ),
        "deit", BK.depth, global_proto_per_class=3,
    )
    before = {k: v.clone() for k, v in sd.items()}
    got = t_pre.fold_normalization_into_patch_embed(
        sd, input_scale=input_scale
    )
    assert set(got) == set(want)
    for key in ("features.patch_embed.proj.weight",
                "features.patch_embed.proj.bias"):
        # the bias shift is a 192-term fp32 sum, taken in another order by
        # each framework: 1e-6 absolute plus 1e-6 relative (|bias| <= ~4)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, rtol=1e-6, err_msg=key)
        assert torch.equal(sd[key], before[key])  # the input is untouched
    assert got["features.pos_embed"] is sd["features.pos_embed"]


def test_normalize_images_matches_jax(rng):
    x = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_pre.normalize_images(torch.from_numpy(x)).numpy(),
        np.asarray(j_pre.normalize_images(jnp.asarray(x))), atol=1e-6,
    )
