"""The port's ServingEngine on the CPU (``device="cpu"``), mirroring
tests/test_serving.py: the fixed-batch padding discipline, parity with the
plain model forward and with the JAX package's ServingEngine, the staging
window and the throughput probe's accounting."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu.serving import ServingEngine as JaxServingEngine
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.data.preprocess import normalize_images
from protopformer_tpu_torch.serving import ServingEngine, no_tf32
from tests.torch_port import (
    assert_tie_free,
    jax_params,
    port_configs,
    port_model,
)

# rollout_discard_ratio 0.7: see tests/test_torch_model.py (trap F2)
BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, rollout_discard_ratio=0.7,
)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)


def _engine(params, **kw):
    sd = state_dict_from_jax(params, "deit", BK.depth, 3)
    kw.setdefault("compute_dtype", torch.float32)
    return ServingEngine(*port_configs(BK, PP), sd, device="cpu", **kw)


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 32, 32, 3)) * 255).astype(np.uint8)


def _model_on_normalized(params, imgs):
    model = port_model(BK, PP, params)
    x = normalize_images(torch.from_numpy(imgs).float() / 255.0)
    with torch.inference_mode():
        return model(x)


def test_serving_engine_matches_model_and_jax_engine():
    params = jax_params(BK, PP, seed=0)
    imgs = _images(4, 11)  # batch_size=4: three chunks, the last padded by 1
    engine = _engine(params, batch_size=4, with_attn=True)
    engine.warmup()
    res = engine(imgs)
    assert res.logits.shape == (11, 4) and res.logits.dtype == np.float32
    assert res.top_class.shape == (11,) and res.top_class.dtype == np.int32
    assert res.cls_token_attn.shape == (11, 16)

    want = _model_on_normalized(params, imgs)
    np.testing.assert_allclose(res.logits, want.logits.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(res.cls_token_attn,
                               want.cls_token_attn.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res.top_class,
                                  np.argmax(want.logits.numpy(), -1))

    jax_res = JaxServingEngine(BK, PP, params, batch_size=4,
                               compute_dtype=jnp.float32, with_attn=True)(imgs)
    assert_tie_free(jax_res.cls_token_attn, PP.final_reserve_num)
    np.testing.assert_allclose(res.logits, jax_res.logits, rtol=0, atol=1e-4)


def test_serving_engine_chunk_pad_mask_at_production_batch():
    """A ragged 397-image request at B=160: 2 full chunks and a 77-image
    tail padded by 83; the padding never reaches the output and at most
    ``stage_window`` chunks are staged at once."""
    params = jax_params(BK, PP, seed=2)
    imgs = _images(9, 397)
    engine = _engine(params, batch_size=160, with_attn=True, stage_window=2)
    res = engine(imgs)
    assert res.logits.shape == (397, 4)
    assert res.cls_token_attn.shape == (397, 16)
    assert 1 <= engine.last_peak_staged <= 2

    want = _model_on_normalized(params, imgs[320:])
    np.testing.assert_allclose(res.logits[320:], want.logits.numpy(),
                               rtol=0, atol=1e-4)
    res160 = engine(imgs[:160])
    np.testing.assert_allclose(res.logits[:160], res160.logits, rtol=0,
                               atol=1e-5)


def test_serving_throughput_probe_counts_and_runs():
    engine = _engine(jax_params(BK, PP, seed=3), batch_size=8)
    out = engine.throughput_probe(n_images=20, reps=2)
    assert out["n_images"] == 20
    assert out["chunks"] == 3  # 8 + 8 + 4 (padded)
    assert out["img_per_sec"] > 0
    assert out["best_img_per_sec"] >= out["img_per_sec"] * 0.99


def test_no_tf32_restores_the_process_settings():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        with no_tf32():
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
        _engine(jax_params(BK, PP, seed=0), batch_size=2)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_serving_engine_rejects_float_input():
    engine = _engine(jax_params(BK, PP, seed=0), batch_size=2)
    with pytest.raises(ValueError, match="uint8"):
        engine(np.zeros((2, 32, 32, 3), np.float32))
