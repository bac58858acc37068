"""The traced slice: ``torch.profiler`` over a short stretch of the cell's
own work after its window, reduced to the device's busy time (the union of
its operations' intervals), the slice's length, the operations by name and
the longest idle gaps with what the host was doing in each.

The union-of-intervals arithmetic is ``chip_smoke.py::profile_chunk``'s:
every device record counts except the profiler's "Command Buffer Full"
marker (a host stall) and user annotations (ranges, not work). Here the
slice's length is the host range the benchmark wraps around it (ending in
a synchronize), so host time before the first kernel and after the last
counts as idle.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

SLICE = "benchmark.slice"
TOP = 10


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def reduce_events(events) -> Dict[str, object]:
    """From ``prof.events()``: {"window_s", "busy_s", "ops" [(name, start
    us, end us)] of the device clipped to the slice, "by_name" [[name, s]]
    largest first, "gaps" [[host op, s]] longest first}."""
    from torch.autograd import DeviceType

    host, device, window = [], [], None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if (e.name != "Command Buffer Full"
                    and not getattr(e, "is_user_annotation", False)):
                device.append((start, end, e.name))
        elif e.name == SLICE:
            window = (start, end)
        else:
            host.append((start, end, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no '{SLICE}' range")
    w0, w1 = window
    ops = [(name, max(s, w0), min(e, w1)) for s, e, name in device
           if e > w0 and s < w1]
    merged = _union([(s, e) for _, s, e in ops])
    busy_us = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    edges = [w0] + [x for span in merged for x in span] + [w1]
    gaps = sorted(((g1 - g0, g0, g1) for g0, g1 in zip(edges[::2], edges[1::2])
                   if g1 > g0), reverse=True)[:TOP]
    named = []
    for length, g0, g1 in gaps:
        mid = (g0 + g1) / 2.0
        covering = [(e - s, name) for s, e, name in host if s <= mid <= e]
        named.append([min(covering)[1] if covering else "(no host op)",
                      length / 1e6])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "ops": ops,
        "by_name": [[n, us / 1e6] for n, us in
                    sorted(by_name.items(), key=lambda kv: -kv[1])],
        "gaps": named,
    }


def trace_slice(run: Callable[[], object], sync: Callable[[], None]
                ) -> Dict[str, object]:
    """Profile ``run()`` followed by ``sync()`` as one slice; returns
    ``reduce_events`` of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SLICE):
            run()
            sync()
    return reduce_events(prof.events())


def breakdown(slice_: Dict[str, object]) -> Dict[str, list]:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, at most ``TOP`` each."""
    return {"device_ops": slice_["by_name"][:TOP],
            "idle_gaps": slice_["gaps"][:TOP]}
