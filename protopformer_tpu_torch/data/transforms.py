"""Host-side image transforms (PIL + numpy; port of
``protopformer_tpu/data/transforms.py``, step for step and draw for draw,
so that one ``np.random.Generator`` gives the same output in both).

Replaces the reference's timm ``create_transform`` pipeline
(ref: main.py:133-156, tools/datasets.py:280-335):

  train: RandomResizedCrop(224, bicubic) + HFlip + RandAugment
         'rand-m9-mstd0.5-inc1' + color-jitter 0.4 + RandomErasing(0.25,
         'pixel') — the timm recipe the reference trains with.
  eval:  resize to 256/224 * size (bicubic) + center-crop + [0,1] floats.
  view:  eval geometry WITHOUT normalization (uint8), for overlays
         (ref: build_dataset_view / build_dataset_noaug,
         tools/datasets.py:77-164).

Normalization itself happens ON DEVICE (data/preprocess.py) so host output
is plain float32 RGB in [0,1] (or uint8 for views).

RandAugment follows timm 0.5.4 semantics exactly (2 ops per image, each
applied with prob 0.5 at a gauss(9, 0.5)-jittered magnitude on the 0-10
level scale, 'inc1' increasing-severity transforms, per-op argument
formulas from timm/data/auto_augment.py @ 0.5.4) — pinned per-op by
tests/test_aug_fidelity.py. timm quirks preserved:

  * color jitter is DISABLED when auto-augment is active (the reference
    passes both color_jitter=0.4 and aa — timm's create_transform only
    applies jitter in the ``elif color_jitter`` branch, so the trained
    recipe has NO jitter);
  * random erasing ('pixel' mode) runs after normalization in timm and
    writes standard-normal noise; here erasing runs pre-normalization
    (normalize happens on device), so the noise is N(mean_c, std_c) per
    channel — the exact preimage of N(0, 1) under the device normalize;
  * PosterizeIncreasing reaches bits=0 (a black image) when the jittered
    magnitude clips at 10 (~2% of applications at m9/mstd0.5).

Known deviations (quantified, not load-bearing): the RandomResizedCrop
10-attempt fallback is a center square crop vs timm's ratio-clamped crop
(hit only for extreme aspect ratios), and the RNG is numpy instead of
python/torch RNG — the sampling DISTRIBUTIONS match, the streams don't
(augmentation randomness is not a parity surface).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

# timm 0.5.4 magnitude denominator (auto_augment.py ``_MAX_LEVEL = 10.``):
# 'm9' means 9/10 severity. (Round-3 used 31 — the TF-RandAugment scale —
# which under-drove every op to ~29% of the trained recipe's strength.)
_MAX_LEVEL = 10.0
_FILL = (124, 116, 104)


def _rrc_params(w, h, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), rng=None):
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.integers(0, w - cw + 1)
            y = rng.integers(0, h - ch + 1)
            return x, y, cw, ch
    # fallback: center crop
    s = min(w, h)
    return (w - s) // 2, (h - s) // 2, s, s


# --- RandAugment ops (timm 'inc1' increasing-severity variants) -----------

def _shear_x(img, level):
    return img.transform(img.size, Image.AFFINE, (1, level, 0, 0, 1, 0),
                         Image.BICUBIC, fillcolor=_FILL)


def _shear_y(img, level):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, level, 1, 0),
                         Image.BICUBIC, fillcolor=_FILL)


def _translate_x(img, level):
    pixels = level * img.size[0]
    return img.transform(img.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                         Image.BICUBIC, fillcolor=_FILL)


def _translate_y(img, level):
    pixels = level * img.size[1]
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                         Image.BICUBIC, fillcolor=_FILL)


def _enhance(factory):
    def op(img, level):
        return factory(img).enhance(1.0 + level)

    return op


def _posterize(img, bits):
    # timm 0.5.4 PosterizeIncreasing reaches bits=0 at max magnitude; PIL
    # posterize keeps the top ``bits`` bits, so 0 bits is a black image
    bits = int(bits)
    if bits <= 0:
        return Image.new(img.mode, img.size, 0)
    return ImageOps.posterize(img, min(bits, 8))


def _solarize(img, thresh):
    return ImageOps.solarize(img, int(thresh))


def _solarize_add(img, add, thresh=128):
    arr = np.asarray(img).astype(np.int32)
    arr = np.where(arr < thresh, np.clip(arr + int(add), 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


def _rotate(img, degrees):
    return img.rotate(degrees, Image.BICUBIC, fillcolor=_FILL)


# (name, apply(img, magnitude_fraction in [-1,1])) — the 15 transforms of
# timm 0.5.4 _RAND_INCREASING_TRANSFORMS with their exact level->arg
# formulas (auto_augment.py: rotate 30deg, shear 0.3, translate-rel 0.45,
# enhance 1±0.9*frac, posterize 4-int(4*frac) bits, solarize
# 256-int(256*frac), solarize-add int(110*frac)); ops whose timm level_fn
# has no _randomly_negate take abs(m)
def _randaug_ops():
    return [
        ("AutoContrast", lambda im, m: ImageOps.autocontrast(im)),
        ("Equalize", lambda im, m: ImageOps.equalize(im)),
        ("Invert", lambda im, m: ImageOps.invert(im)),
        ("Rotate", lambda im, m: _rotate(im, m * 30.0)),
        # 'inc1': PosterizeIncreasing — more magnitude = fewer bits
        ("Posterize", lambda im, m: _posterize(im, 4 - int(abs(m) * 4))),
        # SolarizeIncreasing: more magnitude = lower threshold
        ("Solarize", lambda im, m: _solarize(im, 256 - int(abs(m) * 256))),
        ("SolarizeAdd", lambda im, m: _solarize_add(im, int(abs(m) * 110))),
        ("Color", lambda im, m: _enhance(ImageEnhance.Color)(im, m * 0.9)),
        ("Contrast", lambda im, m: _enhance(ImageEnhance.Contrast)(im, m * 0.9)),
        ("Brightness", lambda im, m: _enhance(ImageEnhance.Brightness)(im, m * 0.9)),
        ("Sharpness", lambda im, m: _enhance(ImageEnhance.Sharpness)(im, m * 0.9)),
        ("ShearX", lambda im, m: _shear_x(im, m * 0.3)),
        ("ShearY", lambda im, m: _shear_y(im, m * 0.3)),
        ("TranslateX", lambda im, m: _translate_x(im, m * 0.45)),
        ("TranslateY", lambda im, m: _translate_y(im, m * 0.45)),
    ]


class RandAugment:
    """timm-style RandAugment: ``num_ops`` random ops at gaussian-jittered
    magnitude, each applied with prob 0.5."""

    def __init__(self, num_ops=2, magnitude=9, magnitude_std=0.5):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.magnitude_std = magnitude_std
        self.ops = _randaug_ops()

    def __call__(self, img: Image.Image, rng: np.random.Generator):
        for _ in range(self.num_ops):
            if rng.uniform() > 0.5:
                continue
            name, op = self.ops[rng.integers(len(self.ops))]
            mag = rng.normal(self.magnitude, self.magnitude_std)
            mag = float(np.clip(mag, 0, _MAX_LEVEL)) / _MAX_LEVEL
            if rng.uniform() < 0.5:
                mag = -mag
            img = op(img, mag)
        return img


class RandomErasing:
    """timm RandomErasing, 'pixel' mode.

    timm erases AFTER normalization with standard-normal noise per pixel
    (timm/data/random_erasing.py ``.normal_()``); this pipeline normalizes
    ON DEVICE, so the pre-normalization equivalent is N(mean_c, std_c) per
    channel — the device's (x - mean)/std maps the region back to exactly
    N(0, 1). Values may leave [0, 1], as timm's do post-norm.
    """

    # ImageNet constants (data/preprocess.py; ref: tools/preprocess.py:3-4)
    _MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    _STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, prob=0.25, scale=(0.02, 1 / 3), ratio=(0.3, 3.3)):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio

    def __call__(self, arr: np.ndarray, rng: np.random.Generator):
        if rng.uniform() > self.prob:
            return arr
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.scale) * area
            log_r = rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1]))
            ar = np.exp(log_r)
            eh = int(round(np.sqrt(target / ar)))
            ew = int(round(np.sqrt(target * ar)))
            if eh < h and ew < w:
                y = rng.integers(0, h - eh + 1)
                x = rng.integers(0, w - ew + 1)
                noise = rng.normal(size=(eh, ew, arr.shape[2]))
                arr[y:y + eh, x:x + ew] = (
                    self._MEAN + self._STD * noise
                ).astype(arr.dtype)
                break
        return arr


def build_train_transform(
    input_size: int = 224,
    color_jitter: float = 0.4,
    aa: Optional[str] = "rand-m9-mstd0.5-inc1",
    reprob: float = 0.25,
    interpolation=Image.BICUBIC,
) -> Callable:
    """(PIL or uint8 array, np rng) -> float32 (H, W, 3) in [0,1]."""
    randaug = None
    if aa and aa.startswith("rand"):
        # parse 'rand-m9-mstd0.5-inc1'
        mag, mstd = 9, 0.5
        for tok in aa.split("-")[1:]:
            if tok.startswith("mstd"):
                mstd = float(tok[4:])
            elif tok.startswith("m"):
                mag = int(tok[1:])
        randaug = RandAugment(num_ops=2, magnitude=mag, magnitude_std=mstd)
        # timm create_transform applies color jitter ONLY when auto-augment
        # is off (transforms_factory.py ``elif color_jitter is not None``) —
        # the reference passes both, so its trained recipe has no jitter
        color_jitter = 0.0
    erasing = RandomErasing(prob=reprob) if reprob > 0 else None

    def transform(img, rng: np.random.Generator) -> np.ndarray:
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        x, y, cw, ch = _rrc_params(*img.size, rng=rng)
        img = img.resize(
            (input_size, input_size), interpolation,
            box=(x, y, x + cw, y + ch),
        )
        if rng.uniform() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if randaug is not None:
            img = randaug(img, rng)
        if color_jitter:
            for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                        ImageEnhance.Color):
                f = 1.0 + rng.uniform(-color_jitter, color_jitter)
                img = enh(img).enhance(f)
        arr = np.asarray(img, np.float32) / 255.0
        if erasing is not None:
            arr = erasing(arr, rng)
        return arr

    return transform


def build_eval_transform(
    input_size: int = 224, crop_pct: Optional[float] = None,
    interpolation=Image.BICUBIC,
) -> Callable:
    """Resize shorter side to size/crop_pct + center crop
    (ref: tools/datasets.py:322-335 — resize int(256/224*size))."""
    if crop_pct is None:
        crop_pct = 224 / 256 if input_size <= 224 else 1.0
    resize_to = int(round(input_size / crop_pct))

    def transform(img, rng=None) -> np.ndarray:
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        w, h = img.size
        if w <= h:
            nw, nh = resize_to, int(round(h * resize_to / w))
        else:
            nw, nh = int(round(w * resize_to / h)), resize_to
        img = img.resize((nw, nh), interpolation)
        left = (nw - input_size) // 2
        top = (nh - input_size) // 2
        img = img.crop((left, top, left + input_size, top + input_size))
        return np.asarray(img, np.float32) / 255.0

    return transform


def build_square_transform(
    input_size: int = 224, interpolation=Image.BILINEAR
) -> Callable:
    """Plain square resize, NO crop — the interpretability-eval protocol's
    transform (ref: eval_interpretability.py:173-176
    ``transforms.Resize((img_size, img_size))``; torchvision Resize defaults
    to bilinear). Output: float32 (H, W, 3) in [0,1]."""

    def transform(img, rng=None) -> np.ndarray:
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        img = img.resize((input_size, input_size), interpolation)
        return np.asarray(img, np.float32) / 255.0

    return transform


def build_view_transform(input_size: int = 224) -> Callable:
    """Unnormalized uint8 view images for overlays (ref: build_dataset_view,
    tools/datasets.py:77-119)."""
    eval_t = build_eval_transform(input_size)

    def transform(img, rng=None) -> np.ndarray:
        return (eval_t(img) * 255.0).astype(np.uint8)

    return transform
