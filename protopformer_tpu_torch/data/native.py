"""ctypes bindings for the native C++ image pipeline (port of
``protopformer_tpu/data/native.py``; the C++ source is the JAX package's
``native/image_pipeline.cpp``).

The library is loaded read-only from ``native/libppf_image.so`` where that
exists. Where it does not, it is built on first use from
``native/image_pipeline.cpp`` with the flags of ``native/Makefile`` (g++ and
libjpeg) into ``build/native/`` at the root of the checkout, which git
ignores: nothing is ever written into ``native/``. A hash of the source and
flags is kept beside the built copy, which is rebuilt when they change.
``is_available()`` is False where no library loads and none builds;
callers then use the PIL path. The native eval transform mirrors
``data/transforms.py::build_eval_transform`` (bicubic shorter-side resize
+ center crop + [0,1] floats); the native train path does decode + crop +
resize with the crop box and flip sampled in Python, so the RNG streams
stay identical to the PIL path's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SOURCE = os.path.join(_NATIVE_DIR, "image_pipeline.cpp")
_SHIPPED_LIB = os.path.join(_NATIVE_DIR, "libppf_image.so")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_BUILT_LIB = os.path.join(BUILD_DIR, "libppf_image.so")
# native/Makefile's CXXFLAGS and LDLIBS
CXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared",
             "-std=c++17", "-Wall"]
LD_LIBS = ["-ljpeg"]

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_LIBS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _build() -> str:
    """Build the library into BUILD_DIR (unless an up-to-date copy is
    there); returns its path. Raises where g++ or libjpeg is missing."""
    stamp = _BUILT_LIB + ".sha256"
    digest = _digest()
    if os.path.exists(_BUILT_LIB) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return _BUILT_LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_BUILT_LIB}.{os.getpid()}.tmp"
    subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                    _SOURCE, *LD_LIBS], check=True, capture_output=True)
    os.replace(tmp, _BUILT_LIB)
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    return _BUILT_LIB


def library_path() -> Optional[str]:
    """The path of the loaded library, or None where none is available."""
    return getattr(_load(), "_name", None)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = (_SHIPPED_LIB if os.path.exists(_SHIPPED_LIB)
                    else _build())
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.ppf_jpeg_dims.argtypes = [u8p, ctypes.c_long, i32p, i32p]
        lib.ppf_decode.argtypes = [u8p, ctypes.c_long, i32p, i32p, u8p]
        lib.ppf_eval_transform.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, f32p,
        ]
        lib.ppf_train_crop_resize.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ]
        for fn in (lib.ppf_jpeg_dims, lib.ppf_decode, lib.ppf_eval_transform,
                   lib.ppf_train_crop_resize):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def _as_u8p(buf: bytes):
    return (ctypes.c_ubyte * len(buf)).from_buffer_copy(buf)


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native image pipeline is not available "
                           "(no library loads and g++/libjpeg cannot build one)")
    return lib


def jpeg_dims(jpeg_bytes: bytes) -> tuple:
    lib = _require()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.ppf_jpeg_dims(
        _as_u8p(jpeg_bytes), len(jpeg_bytes),
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc:
        raise ValueError(f"jpeg header parse failed (rc={rc})")
    return w.value, h.value


def decode(jpeg_bytes: bytes) -> np.ndarray:
    lib = _require()
    w, h = jpeg_dims(jpeg_bytes)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.ppf_decode(
        _as_u8p(jpeg_bytes), len(jpeg_bytes),
        ctypes.byref(ctypes.c_int()), ctypes.byref(ctypes.c_int()),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return out


def eval_transform(jpeg_bytes: bytes, resize_short: int, crop: int) -> np.ndarray:
    """Decode + bicubic shorter-side resize + center crop -> (crop, crop, 3)
    float32 in [0,1]."""
    lib = _require()
    out = np.empty((crop, crop, 3), np.float32)
    rc = lib.ppf_eval_transform(
        _as_u8p(jpeg_bytes), len(jpeg_bytes), resize_short, crop,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc:
        raise ValueError(f"native eval transform failed (rc={rc})")
    return out


def train_crop_resize(
    jpeg_bytes: bytes, x: int, y: int, w: int, h: int,
    out_size: int, flip: bool,
) -> np.ndarray:
    """Decode + crop box + bicubic resize (+ optional flip) -> float32 [0,1]."""
    lib = _require()
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = lib.ppf_train_crop_resize(
        _as_u8p(jpeg_bytes), len(jpeg_bytes), x, y, w, h, out_size,
        1 if flip else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc:
        raise ValueError(f"native train transform failed (rc={rc})")
    return out


def build_native_eval_transform(input_size: int = 224) -> Callable:
    """Path-based replacement for transforms.build_eval_transform: pass it
    as ``HostDataLoader(path_transform=...)`` and JPEG samples decode,
    resize and crop in C++ without a PIL round trip."""
    crop_pct = 224 / 256 if input_size <= 224 else 1.0
    resize_to = int(round(input_size / crop_pct))

    def transform_path(path: str, rng=None) -> np.ndarray:
        with open(path, "rb") as f:
            return eval_transform(f.read(), resize_to, input_size)

    return transform_path


def build_native_train_transform(
    input_size: int = 224,
    color_jitter: float = 0.4,
    aa: Optional[str] = "rand-m9-mstd0.5-inc1",
    reprob: float = 0.25,
) -> Callable:
    """Path-based train transform on the native decoder: the
    RandomResizedCrop box and horizontal flip are SAMPLED IN PYTHON with the
    caller's per-(epoch, index) rng — the exact draw sequence of
    ``transforms.build_train_transform`` — and executed in C++ (DCT-scaled
    decode + crop + bicubic resize + flip, never materializing the
    full-size image). RandAugment / color-jitter ops then run through PIL
    on the small (input_size)^2 crop, and RandomErasing on the float
    array, in the PIL pipeline's op order.
    """
    from PIL import Image, ImageEnhance

    from protopformer_tpu_torch.data.transforms import (
        RandAugment,
        RandomErasing,
        _rrc_params,
    )

    randaug = None
    if aa and aa.startswith("rand"):
        mag, mstd = 9, 0.5
        for tok in aa.split("-")[1:]:
            if tok.startswith("mstd"):
                mstd = float(tok[4:])
            elif tok.startswith("m"):
                mag = int(tok[1:])
        randaug = RandAugment(num_ops=2, magnitude=mag, magnitude_std=mstd)
    erasing = RandomErasing(prob=reprob) if reprob > 0 else None

    def transform_path(path: str, rng) -> np.ndarray:
        with open(path, "rb") as f:
            jb = f.read()
        w, h = jpeg_dims(jb)
        # identical rng draw order to the PIL path (transforms.py):
        # rrc box -> flip -> randaug -> jitter -> erasing
        x, y, cw, ch = _rrc_params(w, h, rng=rng)
        flip = bool(rng.uniform() < 0.5)
        arr = train_crop_resize(jb, x, y, cw, ch, input_size, flip)
        if randaug is not None or color_jitter:
            img = Image.fromarray(
                np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
            )
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

    return transform_path


def build_native_square_transform(input_size: int = 224) -> Callable:
    """Path-based square Resize((s,s)) with no crop — the interpretability
    protocol's transform (transforms.build_square_transform) on the native
    decoder: decode + full-image crop box + resize."""

    def transform_path(path: str, rng=None) -> np.ndarray:
        with open(path, "rb") as f:
            jb = f.read()
        w, h = jpeg_dims(jb)
        return train_crop_resize(jb, 0, 0, w, h, input_size, False)

    return transform_path
