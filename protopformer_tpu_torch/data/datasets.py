"""Dataset index builders (port of ``protopformer_tpu/data/datasets.py``).

The reference wraps each fine-grained dataset in a torch ``Dataset`` class
(ref: tools/datasets.py — ``Cub2011`` :402-474, ``StanfordCars`` :477-589,
``Dogs`` :662-907, ``Aircraft`` :910-1013, ``Cars`` :592-659, ``INatDataset``
:35-75, CIFAR/MNIST branches :170-181). Here, as in the JAX package, the
metadata parsing is split from the IO: a builder returns a
``DatasetIndex`` (paths + integer labels), and ``loader.HostDataLoader``
decodes, augments and batches on the host. A ``synthetic`` dataset
generates deterministic images for tests and smoke trains.

One dispatch differs from the JAX package on purpose (ROADMAP F5):
``build_dataset_index`` maps ``CUB2011`` to the pre-cropped ImageFolder
trees and ``CUB2011U`` to the raw CUB-200-2011 tree, as the original
reference does (tools/datasets.py:96-98, 182-184); the JAX package maps
them the other way round.
"""

from __future__ import annotations

import os
import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

NUM_CLASSES = {
    "CUB2011U": 200,
    "CUB2011": 200,
    "Dogs": 120,
    "Car": 196,
    "Cars": 196,
    "Aircraft": 100,
    "CIFAR10": 10,
    "CIFAR100": 100,
    "MNIST": 10,
    "synthetic": 4,
}


@dataclass
class DatasetIndex:
    """Flat sample index: absolute paths + int labels (+ optional ids)."""

    paths: List[str]
    labels: np.ndarray  # (N,) int32
    num_classes: int
    image_ids: Optional[np.ndarray] = None  # dataset-native ids (CUB)
    # synthetic datasets carry the images inline instead of paths:
    images: Optional[np.ndarray] = None  # (N, H, W, 3) uint8
    # per-sample (xmin, ymin, xmax, ymax) PIL crop boxes applied at load
    # time (Dogs cropped=True mode — one SAMPLE per annotated box, matching
    # the reference's flattened breed_annotations, tools/datasets.py:695-701)
    crop_boxes: Optional[np.ndarray] = None  # (N, 4) int32
    # 0 marks a sample repeated to even out a per-process shard
    # (parallel.shard_index_for_process): an evaluation counts it 0 times
    valid: Optional[np.ndarray] = None  # (N,) float32

    def __len__(self) -> int:
        return len(self.labels)


def _read_space_table(path: str) -> List[List[str]]:
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


def build_cub_index(root: str, train: bool) -> DatasetIndex:
    """CUB-200-2011 from the stock metadata files
    (ref: tools/datasets.py:402-474 — images.txt, image_class_labels.txt,
    train_test_split.txt; labels are 1-based in the files)."""
    base = os.path.join(root, "CUB_200_2011")
    if not os.path.isdir(base):
        base = root  # allow pointing directly at the extracted folder
    images = {int(r[0]): r[1] for r in _read_space_table(os.path.join(base, "images.txt"))}
    labels = {int(r[0]): int(r[1]) - 1 for r in _read_space_table(
        os.path.join(base, "image_class_labels.txt"))}
    split = {int(r[0]): int(r[1]) for r in _read_space_table(
        os.path.join(base, "train_test_split.txt"))}
    want = 1 if train else 0
    ids = sorted(i for i, s in split.items() if s == want)
    return DatasetIndex(
        paths=[os.path.join(base, "images", images[i]) for i in ids],
        labels=np.asarray([labels[i] for i in ids], np.int32),
        num_classes=200,
        image_ids=np.asarray(ids, np.int64),
    )


def build_cub_cropped_index(root: str, train: bool) -> DatasetIndex:
    """The pre-cropped CUB layout: ImageFolder trees
    ``train_cropped_augmented/`` + ``test_cropped/``
    (ref: tools/datasets.py:182-200, the 'CUB2011' dataset)."""
    sub = "train_cropped_augmented" if train else "test_cropped"
    folder = os.path.join(root, sub)
    if train and not os.path.isdir(folder):
        # un-augmented crop tree (scripts/prepare_cub.py without --augment)
        folder = os.path.join(root, "train_cropped")
    if not os.path.isdir(folder):
        # fall back to plain train/test ImageFolder
        folder = os.path.join(root, "train" if train else "test")
    return build_imagefolder_index(folder)


def build_imagefolder_index(folder: str) -> DatasetIndex:
    """torchvision-ImageFolder-compatible tree: folder/<class>/<img>."""
    classes = sorted(
        d for d in os.listdir(folder)
        if os.path.isdir(os.path.join(folder, d))
    )
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(folder, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return DatasetIndex(
        paths=paths, labels=np.asarray(labels, np.int32),
        num_classes=len(classes),
    )


def build_stanford_cars_index(root: str, train: bool) -> DatasetIndex:
    """Stanford Cars from the devkit .mat annotations
    (ref: tools/datasets.py:477-589)."""
    from scipy.io import loadmat

    if train:
        mat = os.path.join(root, "devkit", "cars_train_annos.mat")
        img_dir = os.path.join(root, "cars_train")
    else:
        mat = os.path.join(root, "cars_test_annos_withlabels.mat")
        if not os.path.isfile(mat):
            mat = os.path.join(root, "devkit", "cars_test_annos_withlabels.mat")
        img_dir = os.path.join(root, "cars_test")
    annos = loadmat(mat)["annotations"][0]
    paths, labels = [], []
    for a in annos:
        labels.append(int(a["class"][0, 0]) - 1)
        paths.append(os.path.join(img_dir, str(a["fname"][0])))
    return DatasetIndex(
        paths=paths, labels=np.asarray(labels, np.int32), num_classes=196
    )


def build_stanford_dogs_index(
    root: str, train: bool, cropped: bool = False
) -> DatasetIndex:
    """Stanford Dogs from the split .mat lists (ref: tools/datasets.py:662-907).

    ``cropped=True`` replicates the reference's XML-bbox mode
    (tools/datasets.py:695-701, 844-845, 873-882): every <object> bndbox in
    ``Annotation/<file>`` becomes its OWN sample (multi-dog images
    duplicate), and the loader crops the box before the transform. The
    reference's own pipeline always calls ``cropped=False``
    (tools/datasets.py:101,146,194); the mode is carried for dataset-class
    parity."""
    from scipy.io import loadmat

    mat = loadmat(os.path.join(root, "train_list.mat" if train else "test_list.mat"))
    files = [str(f[0][0]) for f in mat["file_list"]]
    labels = (mat["labels"].reshape(-1).astype(np.int32) - 1)
    if not cropped:
        return DatasetIndex(
            paths=[os.path.join(root, "Images", f) for f in files],
            labels=labels, num_classes=120,
        )
    import xml.etree.ElementTree as ET

    paths, lab, boxes = [], [], []
    for f, y in zip(files, labels):
        ann = os.path.join(root, "Annotation", os.path.splitext(f)[0])
        e = ET.parse(ann).getroot()
        for objs in e.iter("object"):
            bb = objs.find("bndbox")
            boxes.append([int(bb.find(k).text)
                          for k in ("xmin", "ymin", "xmax", "ymax")])
            paths.append(os.path.join(root, "Images", f))
            lab.append(y)
    return DatasetIndex(
        paths=paths, labels=np.asarray(lab, np.int32), num_classes=120,
        crop_boxes=np.asarray(boxes, np.int32),
    )


def build_aircraft_index(root: str, train: bool) -> DatasetIndex:
    """FGVC-Aircraft variant labels (ref: tools/datasets.py:910-1013)."""
    base = os.path.join(root, "fgvc-aircraft-2013b", "data")
    if not os.path.isdir(base):
        base = root
    split = "trainval" if train else "test"
    with open(os.path.join(base, "variants.txt")) as f:
        variants = sorted(line.strip() for line in f if line.strip())
    v2i = {v: i for i, v in enumerate(variants)}
    paths, labels = [], []
    with open(os.path.join(base, f"images_variant_{split}.txt")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            img_id, variant = line.split(" ", 1)
            paths.append(os.path.join(base, "images", img_id + ".jpg"))
            labels.append(v2i[variant])
    return DatasetIndex(
        paths=paths, labels=np.asarray(labels, np.int32),
        num_classes=len(variants),
    )


def build_inat_index(
    root: str, train: bool, year: int = 2019, category: str = "name"
) -> DatasetIndex:
    """iNaturalist from the annotation JSONs (ref: tools/datasets.py:35-75 —
    categories regrouped by the chosen taxonomic level)."""
    split = "train" if train else "val"
    with open(os.path.join(root, f"{split}{year}.json")) as f:
        data = json.load(f)
    with open(os.path.join(root, f"categories{year}.json")) as f:
        categories = json.load(f)
    values = sorted({str(c[category]) for c in categories})
    v2i = {v: i for i, v in enumerate(values)}
    cat_to_label = {
        c["id"]: v2i[str(c[category])] for c in categories
    }
    img_by_id = {im["id"]: im["file_name"] for im in data["images"]}
    paths, labels = [], []
    for ann in data["annotations"]:
        paths.append(os.path.join(root, img_by_id[ann["image_id"]]))
        labels.append(cat_to_label[ann["category_id"]])
    return DatasetIndex(
        paths=paths, labels=np.asarray(labels, np.int32),
        num_classes=len(values),
    )


def build_cifar_index(root: str, train: bool, cifar100: bool = False) -> DatasetIndex:
    """CIFAR-10/100 from the standard python pickle batches
    (ref: tools/datasets.py:170-177 uses torchvision; this parses the same
    files directly — no torchvision dependency)."""
    import pickle

    def load_batch(path, label_key):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return imgs, np.asarray(d[label_key], np.int32)

    if cifar100:
        base = os.path.join(root, "cifar-100-python")
        files = ["train"] if train else ["test"]
        key = b"fine_labels"
        n_classes = 100
    else:
        base = os.path.join(root, "cifar-10-batches-py")
        files = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        key = b"labels"
        n_classes = 10
    all_imgs, all_labels = [], []
    for fname in files:
        imgs, labels = load_batch(os.path.join(base, fname), key)
        all_imgs.append(imgs)
        all_labels.append(labels)
    images = np.concatenate(all_imgs).astype(np.uint8)
    labels = np.concatenate(all_labels)
    return DatasetIndex(
        paths=[f"cifar://{i}" for i in range(len(labels))],
        labels=labels, num_classes=n_classes, images=images,
    )


def build_mnist_index(root: str, train: bool) -> DatasetIndex:
    """MNIST from the IDX files (ref: tools/datasets.py:178-181), replicated
    to 3 channels like torchvision+transforms would produce."""
    import gzip
    import struct

    split = "train" if train else "t10k"

    def open_maybe_gz(name):
        p = os.path.join(root, name)
        if os.path.exists(p + ".gz"):
            return gzip.open(p + ".gz", "rb")
        return open(p, "rb")

    with open_maybe_gz(f"{split}-images-idx3-ubyte") as f:
        _, n, h, w = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(n * h * w), np.uint8).reshape(n, h, w)
    with open_maybe_gz(f"{split}-labels-idx1-ubyte") as f:
        _, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(n), np.uint8).astype(np.int32)
    images = np.repeat(images[..., None], 3, axis=-1)
    return DatasetIndex(
        paths=[f"mnist://{i}" for i in range(len(labels))],
        labels=labels, num_classes=10, images=images,
    )


def build_synthetic_index(
    num_samples: int = 64,
    num_classes: int = 4,
    image_size: int = 32,
    seed: int = 1028,
) -> DatasetIndex:
    """Deterministic synthetic dataset for tests/smoke trains: each class is
    a distinct colored-noise pattern so tiny models can overfit it."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 255, size=(num_classes, image_size, image_size, 3))
    labels = np.arange(num_samples, dtype=np.int32) % num_classes
    noise = rng.uniform(-40, 40, size=(num_samples, image_size, image_size, 3))
    images = np.clip(protos[labels] + noise, 0, 255).astype(np.uint8)
    return DatasetIndex(
        paths=[f"synthetic://{i}" for i in range(num_samples)],
        labels=labels, num_classes=num_classes, images=images,
    )


def build_dataset_index(
    data_set: str, data_path: str, train: bool, **kw
) -> DatasetIndex:
    """Name-dispatched builder (ref: build_dataset, tools/datasets.py:167-277).

    ``CUB2011`` is the reference's pre-cropped ImageFolder layout and
    ``CUB2011U`` the raw CUB-200-2011 tree (ROADMAP F5: the JAX package
    swaps the two)."""
    if data_set in ("CUB2011",):
        return build_cub_cropped_index(data_path, train)
    if data_set in ("CUB2011U",):
        return build_cub_index(data_path, train)
    if data_set in ("Car", "Cars"):
        return build_stanford_cars_index(data_path, train)
    if data_set == "Dogs":
        return build_stanford_dogs_index(data_path, train, **kw)
    if data_set == "Aircraft":
        return build_aircraft_index(data_path, train)
    if data_set == "ImageFolder":
        return build_imagefolder_index(
            os.path.join(data_path, "train" if train else "val")
        )
    if data_set in ("INAT", "INAT19"):
        return build_inat_index(data_path, train, year=2019, **kw)
    if data_set == "CIFAR10":
        return build_cifar_index(data_path, train, cifar100=False)
    if data_set == "CIFAR100":
        return build_cifar_index(data_path, train, cifar100=True)
    if data_set == "MNIST":
        return build_mnist_index(data_path, train)
    if data_set == "synthetic":
        return build_synthetic_index(**kw)
    raise ValueError(f"unknown data_set: {data_set}")
