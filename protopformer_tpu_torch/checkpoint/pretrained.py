"""Pretrained-weight registry and offline cache (port of
``protopformer_tpu/checkpoint/pretrained.py``).

The reference fine-tunes from stock DeiT/CaiT ImageNet weights that
``torch.hub`` downloads at model build with ``check_hash=True`` (ref:
tools/deit_features.py:10-62, tools/deit_models_attn.py:292-296,
tools/cait_models_attn.py:22-31). ``resolve_pretrained(spec)`` takes the
same three kinds of spec as the JAX package:

  * a registered architecture name -> its URL's file in the cache
  * a URL                          -> its file in the cache
  * a local path                   -> returned as it is

Nothing is fetched over the network. A ``file://`` URL is copied into the
cache once and hash-checked; an ``http(s)://`` URL resolves only when its
file is already in the cache, and otherwise raises ``FileNotFoundError``
naming the path to put the file at. The cache is ``$PPF_CACHE_DIR``
(default ``~/.cache/protopformer_tpu``), keyed by file name; FB checkpoints
carry the first 8 sha256 hex digits in the name (``-a1311bcf.pth``), which
the copy checks as torch.hub's ``check_hash=True`` does.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
from urllib.parse import unquote, urlparse

# arch -> URL, one entry per reference registration that publishes weights
# (ref: deit_models_attn.py:292-296/:307-311/:322-326/:337-341/:352-356/
# :367-371/:382-386/:397-401; cait_models_attn.py:22-31). The tiny-image
# registrations (deit_tiny_patch2_*) publish none in the reference either.
PRETRAINED_URLS = {
    "deit_tiny_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_tiny_patch16_224-a1311bcf.pth",
    "deit_small_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_small_patch16_224-cd65a155.pth",
    "deit_base_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_224-b5f2ef4d.pth",
    "deit_tiny_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_tiny_distilled_patch16_224-b40b3cf7.pth",
    "deit_small_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_small_distilled_patch16_224-649709d9.pth",
    "deit_base_distilled_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_base_distilled_patch16_224-df68dfff.pth",
    "deit_base_patch16_384":
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_384-8de9b5d1.pth",
    "deit_base_distilled_patch16_384":
        "https://dl.fbaipublicfiles.com/deit/deit_base_distilled_patch16_384-d0272ac0.pth",
    "cait_xxs24_224": "https://dl.fbaipublicfiles.com/deit/XXS24_224.pth",
    "cait_s24_224": "https://dl.fbaipublicfiles.com/deit/S24_224.pth",
}

_HASH_RE = re.compile(r"-([a-f0-9]{8,})\.pth$")


def cache_dir() -> str:
    return os.environ.get(
        "PPF_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "protopformer_tpu"),
    )


def _check_hash(path: str, filename: str) -> None:
    """torch.hub ``check_hash`` convention: the filename suffix is a prefix
    of the file's sha256 (ref: deit_models_attn.py:294 check_hash=True)."""
    m = _HASH_RE.search(filename)
    if not m:
        return
    want = m.group(1)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    got = h.hexdigest()
    if not got.startswith(want):
        os.remove(path)
        raise RuntimeError(
            f"hash mismatch for {filename}: sha256 {got[:len(want)]} != "
            f"{want} (the copy in the cache was removed)"
        )


def cached_path(url: str) -> str:
    """The local path of ``url``'s file in the cache. A ``file://`` URL is
    copied there once and hash-checked; an ``http(s)://`` URL whose file is
    not there raises ``FileNotFoundError`` (nothing is downloaded)."""
    filename = os.path.basename(url.rstrip("/")) or "ckpt.pth"
    local = os.path.join(cache_dir(), filename)
    if os.path.isfile(local):
        return local
    if not url.startswith("file://"):
        raise FileNotFoundError(
            f"{url} is not in the cache and is not downloaded: put the file "
            f"at {local} (or set PPF_CACHE_DIR to the directory holding it)"
        )
    os.makedirs(cache_dir(), exist_ok=True)
    tmp = local + ".part"
    shutil.copyfile(unquote(urlparse(url).path), tmp)
    os.replace(tmp, local)
    _check_hash(local, filename)
    return local


def resolve_pretrained(spec: str) -> str:
    """Registered name / URL / local path -> local checkpoint path."""
    if spec in PRETRAINED_URLS:
        return cached_path(PRETRAINED_URLS[spec])
    if spec.startswith(("http://", "https://", "file://")):
        return cached_path(spec)
    if os.path.isfile(spec):
        return spec
    known = ", ".join(sorted(PRETRAINED_URLS))
    raise FileNotFoundError(
        f"--pretrained_ckpt {spec!r} is not a file, URL, or registered "
        f"architecture (known: {known})"
    )
