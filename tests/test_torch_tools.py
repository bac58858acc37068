"""The port's offline tools against the JAX package's: the host functions
on the same inputs (exact), ``visualize_prototypes`` on the same weights
and batches (the same files, each PNG within 1 grey level: the two
forwards' fp32 activations differ in their last bits, which can move a
JET colour or a blend by one step), and ``consistency_score`` (the same
per-prototype hit and visibility counts, and so the same score)."""

import os

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from protopformer_tpu.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu.tools import eval_interpretability as j_eval
from protopformer_tpu.tools import visualize as j_vis
from protopformer_tpu_torch.data.local_parts import CubPartAnnotations
from protopformer_tpu_torch.tools import eval_interpretability as t_eval
from protopformer_tpu_torch.tools import visualize as t_vis
from tests.torch_port import jax_params, port_configs, port_model

BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, drop_path_rate=0.0,
    rollout_discard_ratio=0.7,
)
PP = PPNetConfig(
    prototype_shape=(8, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=2,
)


@pytest.fixture(scope="module")
def weights():
    params = jax_params(BK, PP, seed=0)
    return params, port_model(BK, PP, params)


# --- host functions ---------------------------------------------------------

_CFG = object()  # stands for each package's default ConsistencyConfig

def _host_cases(rng):
    act = rng.uniform(size=(32, 32)).astype(np.float32)
    act[10:18, 20:28] += 2.0
    img = rng.integers(0, 255, size=(32, 32, 3)).astype(np.uint8)
    cls_attn = rng.uniform(size=(2, 16)).astype(np.float32)
    sizes = (int(rng.integers(100, 640)), int(rng.integers(100, 640)))
    parts = [(int(p) + 1, int(rng.integers(0, sizes[0])),
              int(rng.integers(0, sizes[1])))
             for p in rng.choice(15, size=9, replace=False)]
    hits = rng.integers(0, 4, size=(8, 15)).astype(np.float64)
    vis = hits + rng.integers(0, 3, size=(8, 15))
    return {
        "find_high_activation_crop": (act, 95.0),
        "gaussian_params": (act.astype(np.float64),),
        "multivariate_gaussian_surface": (
            np.array([60.0, 80.0]), np.array([[90.0, 12.0], [12.0, 40.0]])),
        "scatter_activations_to_grid": (
            rng.uniform(size=(2, 4, 9)).astype(np.float32), cls_attn, 16),
        "jet_overlay": (img, act),
        "discard_mask_image": (img, cls_attn[0], 9, 8),
        "part_hits_for_image": (
            rng.normal(size=(2, 14, 14)).astype(np.float32), parts, *sizes,
            _CFG),
        "aggregate_score": (hits, vis, 0.8),
    }


@pytest.mark.parametrize("name", sorted(_host_cases(
    np.random.default_rng(0))))
def test_host_functions_equal_jax(name):
    args = _host_cases(np.random.default_rng(1028))[name]
    j_mod, t_mod = ((j_eval, t_eval) if name in (
        "part_hits_for_image", "aggregate_score") else (j_vis, t_vis))
    j_args = [j_eval.ConsistencyConfig() if a is _CFG else a for a in args]
    t_args = [t_eval.ConsistencyConfig() if a is _CFG else a for a in args]
    want = getattr(j_mod, name)(*j_args)
    got = getattr(t_mod, name)(*t_args)
    for w, g in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (want, got))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- visualize_prototypes ---------------------------------------------------

def test_visualize_prototypes_writes_the_jax_files(tmp_path, weights):
    from protopformer_tpu.models import construct_ppnet

    params, model = weights
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    views = rng.integers(0, 255, size=(4, 32, 32, 3)).astype(np.uint8)
    labels = np.asarray([0, 1, 0, 1])
    runs = {
        "jax": (j_vis, (construct_ppnet(BK, PP), params), PP,
                {"image": jnp.asarray(x), "label": jnp.asarray(labels)}),
        "port": (t_vis, (model,), port_configs(BK, PP)[1],
                 {"image": x, "label": labels}),
    }
    written = {}
    for side, (mod, model_args, ppnet, batch) in runs.items():
        cfg = mod.VisualizationConfig(
            output_dir=str(tmp_path / side), vis_classes=(0, 1),
            imgs_per_class=1, use_gauss=True, visual_type="slim_gaussian")
        paths = mod.visualize_prototypes(
            *model_args, [(batch, views)], ppnet, cfg, patch_size=8)
        written[side] = sorted(os.path.relpath(p, tmp_path / side)
                               for p in paths)
    assert written["port"] == written["jax"]
    # a class: an overlay and a Gaussian figure a prototype, one mask
    assert len(written["port"]) == 2 * (2 * 2 + 1)
    for rel in written["port"]:
        a = cv2.imread(str(tmp_path / "jax" / rel)).astype(np.int16)
        b = cv2.imread(str(tmp_path / "port" / rel)).astype(np.int16)
        assert a.shape == b.shape, rel
        assert np.abs(a - b).max() <= 1, rel


def test_visualize_prototypes_skips_a_last_batchs_padding(tmp_path, weights):
    """F10: a loader pads its last batch with label-0 rows whose ``valid``
    is 0. The JAX package draws them as class 0's images; the port skips
    them, as the reference's unpadded loader never yields them."""
    from protopformer_tpu.models import construct_ppnet

    params, model = weights
    rng = np.random.default_rng(4)
    x = np.zeros((4, 32, 32, 3), np.float32)
    x[:2] = rng.uniform(size=(2, 32, 32, 3))
    views = rng.integers(0, 255, size=(4, 32, 32, 3)).astype(np.uint8)
    labels = np.asarray([1, 0, 0, 0])
    valid = np.asarray([1.0, 1.0, 0.0, 0.0], np.float32)
    counts = {}
    for side, mod, model_args, ppnet in (
            ("jax", j_vis, (construct_ppnet(BK, PP), params), PP),
            ("port", t_vis, (model,), port_configs(BK, PP)[1])):
        batch = {"image": x, "label": labels, "valid": valid}
        cfg = mod.VisualizationConfig(
            output_dir=str(tmp_path / side), vis_classes=(0, 1),
            imgs_per_class=3, visual_type="slim_gaussian")
        written = mod.visualize_prototypes(*model_args, [(batch, views)],
                                           ppnet, cfg, patch_size=8)
        counts[side] = sum("discard_mask" in p for p in written)
    assert counts == {"jax": 4, "port": 2}


def test_visualize_prototypes_rejects_an_unknown_visual_type(tmp_path,
                                                             weights):
    with pytest.raises(ValueError, match="visual_type"):
        t_vis.visualize_prototypes(
            weights[1], [], port_configs(BK, PP)[1],
            t_vis.VisualizationConfig(output_dir=str(tmp_path),
                                      visual_type="bogus"))


# --- consistency_score ------------------------------------------------------

N_IMG = 16


def _fixture():
    rng = np.random.default_rng(7)
    images = rng.normal(size=(N_IMG, 32, 32, 3)).astype(np.float32)
    ids = np.arange(1, N_IMG + 1)
    annotations = CubPartAnnotations(
        id_to_path={i: f"img{i}.jpg" for i in ids},
        id_to_bbox={i: (0.0, 0.0, 64.0, 64.0) for i in ids},
        id_to_part_loc={
            int(i): [(int(p) + 1, int(rng.integers(0, 64)),
                      int(rng.integers(0, 64)))
                     for p in rng.choice(15, size=rng.integers(2, 9),
                                         replace=False)]
            for i in ids[:-1]  # the last image has no annotation
        },
    )
    sizes = {int(i): (64, 48 + int(i)) for i in ids}
    labels = np.asarray([0, 1, 2, 3] * (N_IMG // 4))

    def loader():
        for s in range(0, N_IMG, 6):
            n = min(6, N_IMG - s)
            valid = np.zeros(6, np.float32)
            valid[:n] = 1.0
            idx = np.arange(s, s + 6) % N_IMG
            yield {"image": images[idx], "label": labels[idx],
                   "valid": valid, "position": idx}

    return loader, annotations, ids, sizes


def _score(module, model_args, ppnet, monkeypatch, **kw):
    """The score and the (hit_sum, vis_sum) that ``aggregate_score`` got."""
    seen = {}
    real = module.aggregate_score

    def capture(hit_sum, vis_sum, part_thresh):
        seen["sums"] = (hit_sum.copy(), vis_sum.copy())
        return real(hit_sum, vis_sum, part_thresh)

    monkeypatch.setattr(module, "aggregate_score", capture)
    loader, annotations, ids, sizes = _fixture()
    score = module.consistency_score(
        *model_args, loader(), annotations, ids, sizes, ppnet,
        module.ConsistencyConfig(half_size=8, img_size=32), **kw)
    monkeypatch.setattr(module, "aggregate_score", real)
    return score, seen["sums"]


def test_consistency_score_equals_jax(weights, monkeypatch):
    from protopformer_tpu.models import construct_ppnet

    params, model = weights
    want, (w_hit, w_vis) = _score(j_eval, (construct_ppnet(BK, PP), params),
                                  PP, monkeypatch)
    got, (g_hit, g_vis) = _score(t_eval, (model,), port_configs(BK, PP)[1],
                                 monkeypatch)
    np.testing.assert_array_equal(g_vis, w_vis)
    np.testing.assert_array_equal(g_hit, w_hit)
    assert w_vis.sum() > 0 and 0 < w_hit.sum() < w_vis.sum()
    assert got == want


def test_consistency_host_workers_are_bit_neutral(weights, monkeypatch):
    pp = port_configs(BK, PP)[1]
    inline = _score(t_eval, (weights[1],), pp, monkeypatch)
    pooled = _score(t_eval, (weights[1],), pp, monkeypatch, host_workers=4)
    assert pooled[0] == inline[0]
    for a, b in zip(pooled[1], inline[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("replicas", [2, 3])
def test_consistency_score_on_a_mesh_is_not_ported(weights, monkeypatch,
                                                   replicas):
    """The name is kept from when a mesh raised; it is ported now.
    On a mesh (one CPU device listed 2 or 3 times, batches of 6 split
    into contiguous slices, one model replica a slice) the score and the
    hit counts equal one device's exactly."""
    import torch

    from protopformer_tpu_torch.parallel import make_mesh

    pp = port_configs(BK, PP)[1]
    one = _score(t_eval, (weights[1],), pp, monkeypatch)
    mesh = make_mesh([torch.device("cpu")] * replicas)
    got = _score(t_eval, (weights[1],), pp, monkeypatch, mesh=mesh)
    assert got[0] == one[0]
    for a, b in zip(got[1], one[1]):
        np.testing.assert_array_equal(a, b)
