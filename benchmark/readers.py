"""Arithmetic the per-layer metrics' readers share. Each reader
(``metrics/<metric>.py``) reads the traced run's record: ``window`` (the
window's counts and the benchmark's own spans), ``slice`` (the profiled
slice: ``busy_s``, ``window_s``, the device operations ``ops`` and the
program's kernel launch counts ``launches``) and the cell's ``config``. A
reader that finds nothing to read returns None."""

from __future__ import annotations

from typing import Callable, Optional

from benchmark import counts, harness


def device_idle(record: dict) -> Optional[float]:
    """% of the slice with no device operation running."""
    s = record["slice"]
    if not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(record: dict, mode: str, flops: Callable[[dict], float]
        ) -> Optional[float]:
    """% of the bf16 peak: ``flops`` an image times the window's images
    over the window."""
    w = record["window"]
    if not w["images"]:
        return None
    cfg = harness.model_cfg(record["config"], mode)
    return 100.0 * flops(cfg) * w["images"] / w["window_s"] \
        / counts.BF16_FLOPS
