"""Tracing and profiling hooks (port of
``protopformer_tpu/utils/profiling.py``).

The reference has no profiler; its closest machinery is MetricLogger's
wall-clock timing and CUDA max-memory. Here:

  * ``trace(log_dir)``: ``torch.profiler.profile`` over the CPU and, on
    the card, CUDA activities, writing a TensorBoard/Chrome trace
    (``<worker>.<time>.pt.trace.json``) into ``log_dir``; with no
    directory it does nothing;
  * ``annotate(name)``: a named host span (``torch.profiler.record_function``)
    that shows in the trace's timeline;
  * ``device_memory_stats()``: each CUDA device's ``torch.cuda.memory_stats``
    byte counters in MiB, keyed by device.

``trace`` and ``device_memory_stats`` run on the card unless the caller
asks for the CPU; with no CUDA device the default raises.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

from protopformer_tpu_torch.core.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: Optional[str], device="cuda") -> Iterator[None]:
    """Profile the enclosed region into ``log_dir`` (nothing if None).
    ``device="cpu"`` traces the CPU activity only."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


def annotate(name: str):
    """A named span visible in the profiler timeline."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Byte counters (current, peak, allocated, reserved, ...) of every
    CUDA device, in MiB; without a CUDA device it raises."""
    resolve_device("cuda")
    out: Dict[str, Dict[str, float]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(torch.device("cuda", i))] = {
            k: v / (1024 ** 2) for k, v in stats.items()
            if "bytes" in k and isinstance(v, (int, float))
        }
    return out
