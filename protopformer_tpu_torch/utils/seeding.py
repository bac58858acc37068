"""Seeding (port of ``protopformer_tpu/utils/seeding.py``).

The reference seeds python/numpy/torch per rank (ref: main.py:241-249,
254-255). The JAX package seeds the host generators and returns its root
PRNG key; here the device's randomness (dropout, stochastic depth) draws
from an explicit ``torch.Generator``, which ``set_seed`` returns. A
data-parallel caller passes ``seed + rank``, as the JAX package folds in
the process index (``cli/train.py`` under ``torchrun``)."""

from __future__ import annotations

import random

import numpy as np
import torch

from protopformer_tpu_torch.core.device import resolve_device


def set_seed(seed: int, device="cuda") -> torch.Generator:
    """Seed python, numpy and torch; return a ``torch.Generator`` on
    ``device`` (CUDA unless the caller asks for the CPU; no CUDA device
    raises) seeded with ``seed``."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator(resolve_device(device)).manual_seed(seed)
