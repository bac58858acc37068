"""The port's data layer (``protopformer_tpu_torch/data``) against the JAX
package's (``protopformer_tpu/data``) on the same inputs.

Contracts:
  * every index builder and ``build_dataset_index`` equal to JAX's on the
    fixture trees of tests/test_data.py (paths, labels, class counts, ids,
    inline images, crop boxes), but for one dispatch that differs on
    purpose (ROADMAP F5): the port maps ``CUB2011`` to the pre-cropped
    ImageFolder trees and ``CUB2011U`` to the raw CUB tree, as the original
    reference does, where JAX swaps them;
  * the train, eval, view and square transforms bit-equal for the same
    ``np.random.Generator``;
  * ``HostDataLoader`` batches bit-equal to JAX's on the same index, seed
    and epoch: the PIL path, and the native path where the library builds,
    with its PIL fallback for a sample it cannot decode;
  * ``unnormalize_images`` within 1e-6 of JAX's; ``local_parts`` equal;
  * ``MixupCutmix`` against the JAX class for the same scalar draws: soft
    labels and cutmix images exact, mixup images within 1e-6;
  * a ``make_train_step(mixup=...)`` step's gradients against ``jax.grad``
    of the JAX train forward on the same mixed batch, within the gradient
    contract of tests/test_torch_train.py (2e-4 * max|g| + 1e-7; the loss
    within 1e-5).
"""

import dataclasses
import json
import os
import pickle
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from protopformer_tpu.core.config import OptimConfig, PPNetConfig, backbone_preset
from protopformer_tpu.data import datasets as j_ds
from protopformer_tpu.data import local_parts as j_parts
from protopformer_tpu.data import loader as j_loader
from protopformer_tpu.data import mixup as j_mixup
from protopformer_tpu.data import native as j_native
from protopformer_tpu.data import preprocess as j_pre
from protopformer_tpu.data import transforms as j_tf
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.train.steps import cross_entropy_loss as j_ce
from protopformer_tpu_torch import data as t_data
from protopformer_tpu_torch import train as t_train
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.data import datasets as t_ds
from protopformer_tpu_torch.data import local_parts as t_parts
from protopformer_tpu_torch.data import loader as t_loader
from protopformer_tpu_torch.data import mixup as t_mixup
from protopformer_tpu_torch.data import native as t_native
from protopformer_tpu_torch.data import preprocess as t_pre
from protopformer_tpu_torch.data import transforms as t_tf
from tests.torch_port import jax_params, port_model


def _jpeg(path, rng, size):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, size=size + (3,), dtype=np.uint8)
                    ).save(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The fixture trees of tests/test_data.py, one root each."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    # ImageFolder: two classes of three JPEGs, train and val
    for split in ("train", "val"):
        for cls in ("alpha", "beta"):
            for i in range(3):
                _jpeg(root / "folder" / split / cls / f"img{i}.jpg", rng,
                      (40, 50))
    # CIFAR-10 and -100 pickles
    base = root / "cifar" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 255, size=(4, 3072)).astype(
                np.uint8), b"labels": [0, 1, 2, 3]}, f)
    base = root / "cifar" / "cifar-100-python"
    base.mkdir()
    for name in ("train", "test"):
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 255, size=(3, 3072)).astype(
                np.uint8), b"fine_labels": [5, 50, 99]}, f)
    # MNIST IDX files
    mnist = root / "mnist"
    mnist.mkdir()
    n, h, w = 6, 28, 28
    for split in ("train", "t10k"):
        with open(mnist / f"{split}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, h, w))
            f.write(rng.integers(0, 255, size=(n * h * w,)).astype(
                np.uint8).tobytes())
        with open(mnist / f"{split}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(np.arange(n, dtype=np.uint8).tobytes())
    # CUB-200-2011: the raw tree with its metadata and parts
    cub = root / "cub" / "CUB_200_2011"
    names = [f"00{c}.Bird_{c}/img_{i}.jpg" for c in (1, 2) for i in range(3)]
    for name in names:
        _jpeg(cub / "images" / name, rng, (40, 60))
    (cub / "images.txt").write_text(
        "".join(f"{i} {nm}\n" for i, nm in enumerate(names, 1)))
    (cub / "image_class_labels.txt").write_text(
        "".join(f"{i} {1 + (i - 1) // 3}\n" for i in range(1, 7)))
    (cub / "train_test_split.txt").write_text(
        "".join(f"{i} {int(i % 3 != 0)}\n" for i in range(1, 7)))
    (cub / "bounding_boxes.txt").write_text(
        "".join(f"{i} 5 5.5 50 30\n" for i in range(1, 7)))
    (cub / "parts").mkdir()
    (cub / "parts" / "part_locs.txt").write_text("".join(
        f"{i} {p} {10.7 + p} 10.2 {1 if p < 3 else 0}\n"
        for i in range(1, 7) for p in range(1, 16)))
    # the pre-cropped CUB trees beside it
    for sub, k in (("train_cropped_augmented", 3), ("test_cropped", 2)):
        for cname in ("001.A", "002.B"):
            for i in range(k):
                _jpeg(root / "cub" / sub / cname / f"{i}.jpg", rng, (8, 8))
    # Stanford Cars, Dogs (with XML boxes), Aircraft, iNat
    from scipy.io import savemat

    cars = root / "cars"
    (cars / "devkit").mkdir(parents=True)
    dt = [("bbox_x1", "O"), ("bbox_y1", "O"), ("bbox_x2", "O"),
          ("bbox_y2", "O"), ("class", "O"), ("fname", "O")]

    def anno(fname, cls):
        return (np.array([[1]]), np.array([[2]]), np.array([[30]]),
                np.array([[40]]), np.array([[cls]]), np.array([fname]))

    annos = np.array([anno("car_a.jpg", 3), anno("car_b.jpg", 196)], dtype=dt)
    for mat in ("devkit/cars_train_annos.mat", "cars_test_annos_withlabels.mat"):
        savemat(str(cars / mat), {"annotations": annos.reshape(1, -1)})
    dogs = root / "dogs"
    dogs.mkdir()
    files = np.empty((2, 1), dtype=object)
    breeds = ("n02085620-Chihuahua", "n02085936-Maltese_dog")
    files[0, 0] = np.array([f"{breeds[0]}/img1.jpg"])
    files[1, 0] = np.array([f"{breeds[1]}/img2.jpg"])
    for mat in ("train_list.mat", "test_list.mat"):
        savemat(str(dogs / mat),
                {"file_list": files, "labels": np.array([[1], [120]])})
    for breed, img, boxes in ((breeds[0], "img1", [(1, 2, 20, 30)]),
                              (breeds[1], "img2", [(0, 0, 9, 9),
                                                   (5, 6, 30, 35)])):
        (dogs / "Annotation" / breed).mkdir(parents=True)
        (dogs / "Annotation" / breed / img).write_text(
            "<annotation>" + "".join(
                f"<object><bndbox><xmin>{a}</xmin><ymin>{b}</ymin>"
                f"<xmax>{c}</xmax><ymax>{d}</ymax></bndbox></object>"
                for a, b, c, d in boxes) + "</annotation>")
    air = root / "aircraft"
    air.mkdir()
    (air / "variants.txt").write_text("707-320\nA310\n")
    for split in ("trainval", "test"):
        (air / f"images_variant_{split}.txt").write_text(
            "0034309 707-320\n0034958 A310\n")
    inat = root / "inat"
    inat.mkdir()
    for split in ("train", "val"):
        (inat / f"{split}2019.json").write_text(json.dumps({
            "images": [{"id": 1, "file_name": "a.jpg"},
                       {"id": 2, "file_name": "b.jpg"}],
            "annotations": [{"image_id": 1, "category_id": 10},
                            {"image_id": 2, "category_id": 20}]}))
    (inat / "categories2019.json").write_text(json.dumps([
        {"id": 10, "name": "sp_a", "genus": "g"},
        {"id": 20, "name": "sp_b", "genus": "g"}]))
    return root


def _assert_same_index(got, want):
    assert got.paths == want.paths
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype
    assert got.num_classes == want.num_classes
    for field in ("image_ids", "images", "crop_boxes"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, field


# (builder name, root under the trees, extra keyword arguments)
_BUILDERS = [
    ("build_imagefolder_index", "folder/train", {}),
    ("build_cub_index", "cub", {}),
    ("build_cub_cropped_index", "cub", {}),
    ("build_stanford_cars_index", "cars", {}),
    ("build_stanford_dogs_index", "dogs", {}),
    ("build_stanford_dogs_index", "dogs", {"cropped": True}),
    ("build_aircraft_index", "aircraft", {}),
    ("build_inat_index", "inat", {}),
    ("build_inat_index", "inat", {"category": "genus"}),
    ("build_cifar_index", "cifar", {}),
    ("build_cifar_index", "cifar", {"cifar100": True}),
    ("build_mnist_index", "mnist", {}),
]


@pytest.mark.parametrize("name,sub,kw", _BUILDERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(_BUILDERS)])
@pytest.mark.parametrize("train", [True, False])
def test_index_builders_match_jax(trees, name, sub, kw, train):
    args = () if name == "build_imagefolder_index" else (train,)
    root = str(trees / sub)
    _assert_same_index(getattr(t_ds, name)(root, *args, **kw),
                       getattr(j_ds, name)(root, *args, **kw))


_DISPATCH = [("ImageFolder", "folder"), ("Car", "cars"), ("Cars", "cars"),
             ("Dogs", "dogs"), ("Aircraft", "aircraft"), ("INAT", "inat"),
             ("INAT19", "inat"), ("CIFAR10", "cifar"), ("CIFAR100", "cifar"),
             ("MNIST", "mnist"), ("synthetic", None)]


@pytest.mark.parametrize("data_set,sub", _DISPATCH)
@pytest.mark.parametrize("train", [True, False])
def test_build_dataset_index_matches_jax(trees, data_set, sub, train):
    root = str(trees / sub) if sub else ""
    _assert_same_index(t_ds.build_dataset_index(data_set, root, train),
                       j_ds.build_dataset_index(data_set, root, train))
    assert t_ds.NUM_CLASSES == j_ds.NUM_CLASSES
    with pytest.raises(ValueError, match="unknown data_set"):
        t_ds.build_dataset_index("nope", root, train)


@pytest.mark.parametrize("train", [True, False])
def test_cub_modes_follow_the_reference_not_jax(trees, train):
    """F5, the one dispatch that differs on purpose: the port's ``CUB2011``
    is the pre-cropped ImageFolder layout and its ``CUB2011U`` the raw
    CUB-200-2011 tree, as in the original reference; the JAX package
    swaps them."""
    root = str(trees / "cub")
    got = {m: t_ds.build_dataset_index(m, root, train)
           for m in ("CUB2011", "CUB2011U")}
    want = {m: j_ds.build_dataset_index(m, root, train)
            for m in ("CUB2011", "CUB2011U")}
    _assert_same_index(got["CUB2011"], want["CUB2011U"])
    _assert_same_index(got["CUB2011U"], want["CUB2011"])
    _assert_same_index(got["CUB2011U"], t_ds.build_cub_index(root, train))
    assert got["CUB2011U"].image_ids is not None
    assert got["CUB2011"].paths != got["CUB2011U"].paths


def test_synthetic_index_matches_jax():
    kw = dict(num_samples=10, num_classes=3, image_size=16, seed=5)
    _assert_same_index(t_ds.build_synthetic_index(**kw),
                       j_ds.build_synthetic_index(**kw))


# --- transforms ---------------------------------------------------------------

def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in ((90, 70), (48, 120), (64, 64))]


@pytest.mark.parametrize("reprob,aa", [(0.25, "rand-m9-mstd0.5-inc1"),
                                       (1.0, "rand-m7-mstd1.0"),
                                       (0.0, None)])
def test_train_transform_is_bit_equal_to_jax(reprob, aa):
    """40 seeds a setting reach every RandAugment op (15 ops, 2 draws a
    seed), the erasing and, with no auto-augment, the color jitter."""
    got_t = t_tf.build_train_transform(48, 0.4, aa, reprob)
    want_t = j_tf.build_train_transform(48, 0.4, aa, reprob)
    for seed in range(40):
        img = _images(seed)[seed % 3]
        got = got_t(img, np.random.default_rng(seed))
        want = want_t(img, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [32, 224, 256])
def test_eval_view_and_square_transforms_are_bit_equal_to_jax(size):
    for img in _images(size):
        for name in ("build_eval_transform", "build_view_transform",
                     "build_square_transform"):
            got = getattr(t_tf, name)(size)(Image.fromarray(img))
            want = getattr(j_tf, name)(size)(Image.fromarray(img))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# --- the loader -----------------------------------------------------------------

def _loader_pair(index, transform_name, shuffle, drop_last, epoch,
                 path_transform=None, size=32):
    out = []
    for tf_mod, ld_mod, pt in ((t_tf, t_loader, path_transform),
                               (j_tf, j_loader, path_transform)):
        tf = getattr(tf_mod, transform_name)(size)
        ptf = None
        if pt is not None:
            native = t_native if tf_mod is t_tf else j_native
            ptf = getattr(native, pt)(size)
        loader = ld_mod.HostDataLoader(index, tf, batch_size=4,
                                       shuffle=shuffle, seed=3,
                                       drop_last=drop_last, num_workers=3,
                                       path_transform=ptf)
        loader.set_epoch(epoch)
        out.append((len(loader), list(loader)))
    return out


def _assert_same_batches(pair):
    (n_got, got), (n_want, want) = pair
    assert n_got == n_want == len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shuffle,drop_last,epoch,transform", [
    (True, True, 0, "build_train_transform"),
    (True, True, 2, "build_train_transform"),
    (False, False, 0, "build_eval_transform"),
])
def test_loader_batches_are_bit_equal_to_jax_pil_path(trees, shuffle,
                                                      drop_last, epoch,
                                                      transform):
    """The raw CUB tree's 6 JPEGs plus the ImageFolder's 6 through PIL: the
    shuffled train batches of an epoch (4 a batch, the ragged 4 dropped)
    and the padded, masked eval batches (the last holds 4 of 4 here, the
    synthetic index below pads)."""
    index = t_ds.build_dataset_index("ImageFolder", str(trees / "folder"),
                                     True)
    _assert_same_batches(_loader_pair(index, transform, shuffle, drop_last,
                                      epoch))


def test_loader_pads_and_masks_the_last_batch_like_jax():
    index = t_ds.build_synthetic_index(num_samples=10, image_size=20)
    pair = _loader_pair(index, "build_eval_transform", False, False, 0,
                        size=16)
    _assert_same_batches(pair)
    batches = pair[0][1]
    assert len(batches) == 3
    np.testing.assert_array_equal(batches[-1]["valid"], [1, 1, 0, 0])
    assert float(np.abs(batches[-1]["image"][2:]).sum()) == 0.0


def test_loader_batches_are_bit_equal_to_jax_native_path(trees, tmp_path):
    """The native path (where the library loads) for train and eval: the
    same batches as JAX's native loader, and a PNG among the JPEGs takes
    the PIL fallback in both, with one warning."""
    if not t_native.is_available() or not j_native.is_available():
        pytest.skip("the native image library does not build here")
    index = t_ds.build_imagefolder_index(str(trees / "folder" / "train"))
    png = tmp_path / "odd.png"
    Image.open(index.paths[1]).save(png)
    index.paths[1] = str(png)
    for transform, pt in (("build_train_transform",
                           "build_native_train_transform"),
                          ("build_eval_transform",
                           "build_native_eval_transform")):
        with pytest.warns(UserWarning, match="falling back to PIL"):
            pair = _loader_pair(index, transform, True, False, 1,
                                path_transform=pt)
        _assert_same_batches(pair)


def test_native_library_builds_outside_native_dir(monkeypatch, tmp_path):
    """Where native/ holds no library, the port builds its own copy with
    the Makefile's flags into its build directory, never into native/, and
    the copy decodes as the shipped one does."""
    import shutil
    import subprocess

    if shutil.which("g++") is None or not os.path.exists(
            "/usr/include/jpeglib.h"):
        pytest.skip("g++ or the libjpeg headers are missing")
    native_dir = os.path.dirname(t_native._SOURCE)
    before = sorted(os.listdir(native_dir))
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_native, "_BUILT_LIB", str(tmp_path / "lib.so"))
    path = t_native._build()
    assert path == str(tmp_path / "lib.so") and os.path.exists(path)
    assert t_native._build() == path  # up to date: not rebuilt
    assert sorted(os.listdir(native_dir)) == before
    out = subprocess.run(["nm", "-D", path], capture_output=True, text=True)
    for sym in ("ppf_decode", "ppf_eval_transform", "ppf_train_crop_resize"):
        assert sym in out.stdout


def test_loader_mesh_is_not_ported_yet():
    index = t_ds.build_synthetic_index(num_samples=4, image_size=8)
    with pytest.raises(NotImplementedError, match="item 13"):
        t_loader.HostDataLoader(index, t_tf.build_eval_transform(8), 2,
                                False, mesh=object())


# --- preprocess, local parts, package exports ----------------------------------

def test_unnormalize_images_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 5, 5, 3)).astype(np.float32)
    got = t_pre.unnormalize_images(torch.from_numpy(x)).numpy()
    want = np.asarray(j_pre.unnormalize_images(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    back = t_pre.normalize_images(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5, rtol=0)


def test_local_parts_match_jax(trees):
    base = str(trees / "cub" / "CUB_200_2011")
    got, want = t_parts.load_cub_parts(base), j_parts.load_cub_parts(base)
    assert got.id_to_path == want.id_to_path
    assert got.id_to_bbox == want.id_to_bbox
    assert got.id_to_part_loc == want.id_to_part_loc
    assert got.path_to_id() == want.path_to_id()
    assert got.id_to_part_loc[1] == [(1, 11, 10), (2, 12, 10)]
    for x, y in ((10, 10), (0, 0), (55, 35.5), (55.1, 20)):
        assert t_parts.in_bbox(x, y, got.id_to_bbox[1]) == \
            j_parts.in_bbox(x, y, want.id_to_bbox[1])
    assert t_parts.NUM_PARTS == j_parts.NUM_PARTS


def test_data_package_exports_what_jax_exports():
    import protopformer_tpu.data as j_data

    names = {n for n in dir(j_data) if not n.startswith("_")} - {
        "datasets", "loader", "mixup", "preprocess", "transforms"}
    assert names <= set(dir(t_data))


# --- mixup / cutmix ---------------------------------------------------------------

def _jax_draws(mix, key, h, w):
    """The JAX class's scalar draws from ``key``, as its __call__ makes
    them."""
    r_apply, r_switch, r_lam, r_box = jax.random.split(key, 4)
    use_cutmix = (jax.random.uniform(r_switch) < mix.switch_prob
                  if mix.mixup_alpha > 0 and mix.cutmix_alpha > 0
                  else jnp.asarray(mix.cutmix_alpha > 0))
    alpha = jnp.where(use_cutmix, mix.cutmix_alpha or 1.0,
                      mix.mixup_alpha or 1.0)
    lam = jax.random.beta(r_lam, alpha, alpha)
    apply = jax.random.uniform(r_apply) < mix.prob
    r1, r2 = jax.random.split(r_box)
    return t_mixup.MixDraws(bool(apply), bool(use_cutmix), float(lam),
                            int(jax.random.randint(r1, (), 0, h)),
                            int(jax.random.randint(r2, (), 0, w)))


_MIX = [dict(mixup_alpha=0.0, cutmix_alpha=1.0),  # main_train's defaults
        dict(mixup_alpha=0.8, cutmix_alpha=0.0, label_smoothing=0.1),
        dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5),
        dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.5)]


@pytest.mark.parametrize("cfg", _MIX, ids=["cutmix", "mixup", "switch",
                                           "prob"])
def test_mixup_cutmix_matches_jax_for_the_same_draws(cfg):
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(6, 24, 20, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(6,)).astype(np.int32)
    j_mix = j_mixup.MixupCutmix(num_classes=10, **cfg)
    t_mix = t_mixup.MixupCutmix(num_classes=10, **cfg)
    kinds = set()
    for seed in range(8):
        key = jax.random.key(seed)
        draws = _jax_draws(j_mix, key, 24, 20)
        kinds.add((draws.apply, draws.use_cutmix))
        want = j_mix(key, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        got = t_mix.apply({"image": torch.from_numpy(x),
                           "label": torch.from_numpy(y)}, draws)
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))
        if draws.apply and not draws.use_cutmix:
            np.testing.assert_allclose(got["image"].numpy(),
                                       np.asarray(want["image"]), atol=1e-6,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(got["image"].numpy(),
                                          np.asarray(want["image"]))
    if "switch_prob" in cfg:  # both kinds drawn
        assert {cutmix for _, cutmix in kinds} == {True, False}
    if cfg.get("prob", 1.0) < 1.0:  # a batch left unmixed
        assert False in {applied for applied, _ in kinds}


def test_mixup_draws_come_from_the_callers_generator():
    mix = t_mixup.MixupCutmix(mixup_alpha=0.8, cutmix_alpha=1.0)
    batch = {"image": torch.rand((4, 8, 8, 3)),
             "label": torch.tensor([0, 1, 2, 3])}
    a = mix(batch, np.random.default_rng(9))
    b = mix(batch, np.random.default_rng(9))
    assert torch.equal(a["image"], b["image"])
    assert torch.equal(a["label"], b["label"])
    assert a["label"].shape == (4, 200)
    draws = {mix.draw(np.random.default_rng(s), 8, 8).use_cutmix
             for s in range(20)}
    assert draws == {True, False}


def test_train_step_with_mixup_matches_jax_gradients():
    """``make_train_step(mixup=...)`` on a micro DeiT PPNet (fp32, drop path
    0, the PPC gate 0): the step mixes the batch with JAX's draws (cutmix
    at main_train's defaults), and its loss and gradients are held to
    ``jax.grad`` of the JAX train forward's soft-label CE on JAX's mixed,
    normalized batch."""
    bk = dataclasses.replace(backbone_preset("deit_micro_test"),
                             name="tiny-test", rollout_discard_ratio=0.7,
                             drop_path_rate=0.0)
    pp = PPNetConfig(prototype_shape=(40, 16, 1, 1), num_classes=4,
                     reserve_layers=(2,), reserve_token_nums=(9,),
                     use_global=True, global_proto_per_class=3)
    params = jax_params(bk, pp, seed=0)
    x = np.random.default_rng(4).uniform(size=(4, 32, 32, 3)).astype(
        np.float32)
    labels = np.array([0, 2, 1, 3], np.int32)
    j_mix = j_mixup.MixupCutmix(num_classes=4)
    key = jax.random.key(3)
    draws = _jax_draws(j_mix, key, 32, 32)
    assert draws.apply and draws.use_cutmix
    mixed = j_mix(key, {"image": jnp.asarray(x), "label": jnp.asarray(labels)})
    j_model = j_construct(bk, pp)

    def loss_fn(p):
        out = j_model.apply({"params": p},
                            j_pre.normalize_images(mixed["image"]),
                            train=True)
        return j_ce(out.logits, mixed["label"])

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    class FixedDraws(t_mixup.MixupCutmix):
        def draw(self, rng, h, w):
            return draws

    model = port_model(bk, pp, params)
    opt = t_config.OptimConfig(**dataclasses.asdict(OptimConfig(
        epochs=10, warmup_epochs=0)))
    state = t_train.create_train_state(
        model, t_train.make_optimizer(opt, model, 4), device="cpu")
    step = t_train.make_train_step(model, t_config.PPNetConfig(
        **dataclasses.asdict(pp)), opt, mixup=FixedDraws(num_classes=4),
        device="cpu")
    _, metrics = step(state, {"image": x, "label": labels},
                      torch.Generator().manual_seed(0), 0.0)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss),
                               atol=1e-5)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_grads), bk.arch,
                               bk.depth, pp.global_proto_per_class,
                               bk.depth_token_only)
    checked = 0
    for name, p in state.model.named_parameters():
        if p.grad is None:
            continue
        g = want[name].numpy()
        scale = max(float(np.abs(g).max()), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=2e-4 * scale + 1e-7, err_msg=name)
        checked += 1
    assert checked == len(want) - 3  # all but ones and the frozen heads
