"""Epoch-granular LR schedules (port of
``protopformer_tpu/train/scheduler.py``).

The reference steps a timm ``CosineLRScheduler`` once per epoch, so the LR
is a staircase, constant within an epoch; each parameter group scales the
same shape from its own base LR. With t the epoch:
  warmup (t < warmup_epochs):
      warmup_lr + t * (base - warmup_lr) / warmup_epochs
  cosine:
      min_lr + 0.5 * (base - min_lr) * (1 + cos(pi * (t mod epochs) / epochs))
  from epochs * cycle_limit on: min_lr
'step' is base * decay_rate ** floor(t / decay_epochs). A schedule is a
host-side callable from the optimizer step to the LR.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from protopformer_tpu_torch.core.config import OptimConfig

Schedule = Callable[[int], float]


def timm_noise_table(
    epochs_total: int,
    noise_range: Optional[Sequence[float]],
    noise_pct: float,
    noise_std: float,
    seed: int,
) -> Optional[np.ndarray]:
    """Per-epoch multiplicative LR noise as timm's ``Scheduler._add_noise``
    draws it: ``torch.randn`` from ``Generator(seed + t)``, redrawn until
    |noise| < noise_pct, inside [lo, hi) of ``noise_range`` (one value: from
    that epoch on). None when noise is off."""
    if noise_range is None:
        return None
    lo, hi = ((noise_range[0], noise_range[1]) if len(noise_range) > 1
              else (noise_range[0], float("inf")))
    out = np.zeros((max(epochs_total, 1),), np.float32)
    for t in range(epochs_total):
        if not lo <= t < hi:
            continue
        g = torch.Generator()
        g.manual_seed(seed + t)
        while True:
            n = torch.randn(1, generator=g).item() * noise_std
            if abs(n) < noise_pct:
                break
        out[t] = n
    return out


def cosine_epoch_schedule(
    base_lr: float,
    epochs: int,
    warmup_epochs: int,
    warmup_lr: float,
    min_lr: float,
    steps_per_epoch: int,
    cycle_limit: int = 1,
    noise: Optional[np.ndarray] = None,
) -> Schedule:
    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        t = float(epoch)
        if t >= epochs * cycle_limit:
            lr = min_lr
        elif t < warmup_epochs:
            lr = warmup_lr + t * (base_lr - warmup_lr) / max(warmup_epochs, 1)
        else:
            lr = min_lr + 0.5 * (base_lr - min_lr) * (
                1.0 + math.cos(math.pi * (t % epochs) / epochs))
        if noise is not None:
            lr += lr * float(noise[min(max(epoch, 0), len(noise) - 1)])
        return lr

    return schedule


def step_epoch_schedule(base_lr: float, decay_epochs: float,
                        decay_rate: float, steps_per_epoch: int) -> Schedule:
    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        return base_lr * decay_rate ** math.floor(epoch / decay_epochs)

    return schedule


def make_group_schedules(cfg: OptimConfig, steps_per_epoch: int
                         ) -> Dict[str, Schedule]:
    """One schedule per parameter group from that group's base LR; all
    groups share one noise table (timm seeds it by seed + epoch only)."""
    bases = {
        "features": cfg.features_lr,
        "add_on": cfg.add_on_layers_lr,
        "prototypes": cfg.prototype_vectors_lr,
    }
    noise = timm_noise_table(
        cfg.epochs * cfg.lr_cycle_limit + cfg.cooldown_epochs,
        None if cfg.lr_noise is None
        else [n * cfg.epochs for n in cfg.lr_noise],
        cfg.lr_noise_pct, cfg.lr_noise_std, cfg.noise_seed,
    )
    out = {}
    for name, base in bases.items():
        if cfg.sched == "cosine":
            out[name] = cosine_epoch_schedule(
                base, cfg.epochs, cfg.warmup_epochs, cfg.warmup_lr,
                cfg.min_lr, steps_per_epoch, cycle_limit=cfg.lr_cycle_limit,
                noise=noise,
            )
        elif cfg.sched == "step":
            out[name] = step_epoch_schedule(
                base, cfg.decay_epochs, cfg.decay_rate, steps_per_epoch
            )
        else:
            raise ValueError(f"unknown sched: {cfg.sched}")
    return out
