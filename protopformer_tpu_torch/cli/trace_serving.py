"""Where a served request's time goes, read from the program's own spans.

    python -m protopformer_tpu_torch.cli.trace_serving --preset <backbone> \
        --out <dir> [--seed 0]

Builds a ``ServingEngine`` over the backbone preset with the CUB head
(``PPNetConfig``'s defaults: 2000 local and 2000 global prototypes of
width 192, 200 classes, 81 tokens kept at block 11) in bf16 speed mode
(``rollout_exact_discard=False``) at chunks of 160 on the card, with
weights drawn from ``--seed``; serves ``WARM_REQUESTS`` requests of
``IMAGES`` seeded host uint8 images (8 chunks), then profiles one more
(CPU and CUDA activity), exports that trace to ``<dir>/trace.json`` and
reads it beside ``utils.profiling.spans()``. It writes
``<dir>/report.json`` and prints it:

* ``span_us``: µs a span's enter and exit take on this host with no
  profiler collecting (``off``), with one collecting (``on``), and, on the
  card, as a kernel entry's span around a timed launch context that
  launches nothing (``on_timed_launch``; ``launch_context_off`` is that
  context alone with no profiler, the part every launch pays anyway);
* ``spans_per_chunk`` and ``timed_launches_per_chunk`` in the profiled
  request, and ``span_share``: their cost at those rates over the
  profiled stretch's length (``slice_ms``);
* ``busy_ms`` (the union of the device's operations) and ``device_idle``
  over ``slice_ms``; ``lead_in_ms`` (the request's ``serve.request``
  start to its first ``serve.dispatch`` start, in a list) against
  ``idle_ms``;
* ``gaps``: the ``TOP`` longest stretches of the profiled stretch with
  no device operation, each with the innermost program span and the
  innermost host operation over its middle; ``idle_ms_by_span``: every
  such stretch's length summed by that span;
* ``enqueue_ms``: with no profiler, the host ms one chunk's forward takes
  to enqueue on an idle device (median of 5), against the profiled
  request's mean ``serve.dispatch``: what the profiler adds to the host;
* ``slice_ms_spans_on`` and ``slice_ms_spans_off``: ``PAIRS`` more
  requests profiled alike each, in alternating order, with the program's
  spans recording and with them held off (``spans_held_off``): what
  tracing adds to a profiled request on the served path itself.

``report`` also serves an engine on the CPU, where there are no device
operations: every stretch is idle and ``on_timed_launch`` is not read.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from protopformer_tpu_torch.core.device import resolve_device
from protopformer_tpu_torch.utils import profiling

SLICE = "trace_serving.requests"  # the profiled requests' range
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BATCH = 160
IMAGES = 8 * BATCH
WARM_REQUESTS = 4
TOP = 5
PAIRS = 3


def build_engine(preset: str, seed: int, device: torch.device):
    """A bf16 speed ``ServingEngine`` over ``preset`` with the CUB head."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.serving import ServingEngine

    backbone = backbone_preset(preset, rollout_exact_discard=False)
    ppnet = PPNetConfig()
    model = construct_ppnet(backbone, ppnet,
                            generator=torch.Generator().manual_seed(seed))
    return ServingEngine(backbone, ppnet, model.state_dict(),
                         batch_size=BATCH, compute_dtype=torch.bfloat16,
                         device=device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span_cost_us(device: torch.device, n: int = 20000) -> Dict[str, float]:
    """µs per enter and exit of a span: off, on and, on the card, as a
    kernel entry's span around a timed launch context."""
    from torch.profiler import ProfilerActivity, profile

    from protopformer_tpu_torch.kernels import _build

    operand = torch.zeros(8, 8, device=device)

    def loop(count: int, kernel: bool = False, span: bool = True) -> float:
        t0 = time.perf_counter()
        for _ in range(count):
            if not span:
                with _build.on_device(device):
                    pass
            elif kernel:
                with profiling.span("span_cost", operand):
                    with _build.on_device(device):
                        pass
            else:
                with profiling.span("span_cost"):
                    pass
        return (time.perf_counter() - t0) / count * 1e6

    loop(1000)
    out = {"off": loop(n)}
    cuda = device.type == "cuda"
    if cuda:
        out["launch_context_off"] = loop(n, span=False)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities):
        loop(100)
        out["on"] = loop(n // 10)
        if cuda:
            out["on_timed_launch"] = loop(n // 10, kernel=True)
        sync(device)
    return out


def enqueue_ms(engine, device: torch.device, reps: int = 5) -> float:
    """Host ms to enqueue one chunk's forward on an idle device, no
    profiler collecting (median of ``reps``)."""
    size = engine._img_size
    chunk = torch.zeros((engine.batch_size, size, size, 3), dtype=torch.uint8,
                        device=device)
    times = []
    for _ in range(reps + 1):
        sync(device)
        t0 = time.perf_counter()
        engine._forward(chunk)
        times.append((time.perf_counter() - t0) * 1e3)
    sync(device)
    return statistics.median(times[1:])


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def window(events: List[dict]) -> Tuple[float, float]:
    """(start, end) µs of the profiled requests' range in an exported
    trace's events."""
    (w,) = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == SLICE and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    return w


def busy(events: List[dict], w: Tuple[float, float]
         ) -> List[Tuple[float, float]]:
    """The union of the device's operations inside ``w``, clipped to it."""
    w0, w1 = w
    return _union([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1))
                   for e in events if e.get("cat") in DEVICE_CATS
                   and e["ts"] + e.get("dur", 0) > w0 and e["ts"] < w1])


def idle_gaps(events: List[dict], w: Tuple[float, float]
              ) -> List[Tuple[float, float]]:
    """The stretches of ``w`` with no device operation, longest first."""
    edges = [w[0]] + [x for span in busy(events, w) for x in span] + [w[1]]
    gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
    return sorted(gaps, key=lambda g: g[0] - g[1])


def innermost(events: List[dict], at: float, cat: str, keep) -> str:
    """The name of the shortest complete event of category ``cat`` whose
    name ``keep`` accepts that covers the time ``at``."""
    covering = [(e["dur"], e["name"]) for e in events
                if e.get("ph") == "X" and e.get("cat") == cat
                and keep(e["name"]) and e["ts"] <= at <= e["ts"] + e["dur"]]
    return min(covering)[1] if covering else "(none)"


def name_gaps(events: List[dict], span_names: set) -> List[dict]:
    """Every idle stretch of the profiled requests, longest first, with the
    program span and the host operation over its middle."""
    out = []
    for g0, g1 in idle_gaps(events, window(events)):
        mid = (g0 + g1) / 2.0
        out.append({
            "ms": (g1 - g0) / 1e3,
            "span": innermost(events, mid, "user_annotation",
                              span_names.__contains__),
            "host_op": innermost(events, mid, "cpu_op", lambda name: True),
        })
    return out


def idle_by_span(gaps: List[dict]) -> Dict[str, float]:
    """The gaps' ms summed by the span over each, largest first."""
    out: Dict[str, float] = {}
    for g in gaps:
        out[g["span"]] = out.get(g["span"], 0.0) + g["ms"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def lead_ins_ms(spans: List[dict]) -> List[float]:
    """Per request, ms from its ``serve.request`` start to the start of its
    first ``serve.dispatch``."""
    first: Dict[int, int] = {}
    for s in spans:
        if s["name"] == "serve.dispatch":
            r = s["request"]
            first[r] = min(first.get(r, s["start_ns"]), s["start_ns"])
    return [(first[s["request"]] - s["start_ns"]) / 1e6 for s in spans
            if s["name"] == "serve.request" and s["request"] in first]


@contextlib.contextmanager
def spans_held_off():
    """Hold the program's spans and launch timing off while a profiler
    collects: both read the profiler's flag through
    ``profiling._autograd_profiler``, here a stand-in whose flag is
    False."""
    real = profiling._autograd_profiler
    profiling._autograd_profiler = SimpleNamespace(_is_profiler_enabled=False)
    try:
        yield
    finally:
        profiling._autograd_profiler = real


def profiled(engine, images: np.ndarray):
    """One request under the profiler, inside the ``SLICE`` range that
    ends after a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    device = engine.device
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(SLICE):
            engine(images)
            sync(device)
    return prof


def slice_ms(prof) -> float:
    """The host length of a profile's ``SLICE`` range."""
    (e,) = [e for e in prof.events() if e.name == SLICE
            and e.device_type == torch.autograd.DeviceType.CPU]
    return e.time_range.elapsed_us() / 1e3


def report(engine, images: np.ndarray, out: Path) -> dict:
    """Serve, profile and read as the module's docstring says."""
    device = engine.device
    for _ in range(WARM_REQUESTS):
        engine(images)
    sync(device)
    prof = profiled(engine, images)
    spans = profiling.spans()
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    w = window(events)
    length_ms = (w[1] - w[0]) / 1e3
    busy_ms = sum(e - s for s, e in busy(events, w)) / 1e3
    gaps = name_gaps(events, {s["name"] for s in spans})
    chunks = -(-images.shape[0] // engine.batch_size)
    launches = sum(s["timed_launches"] for s in spans)
    cost = span_cost_us(device)
    timed_us = (cost["on_timed_launch"] - cost["on"]
                - cost["launch_context_off"] if launches else 0.0)
    share_us = len(spans) * cost["on"] + launches * timed_us
    paired: Dict[bool, List[float]] = {True: [], False: []}
    for i in range(PAIRS):
        for on in (i % 2 == 0, i % 2 == 1):  # which goes first alternates
            with contextlib.nullcontext() if on else spans_held_off():
                paired[on].append(slice_ms(profiled(engine, images)))
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "images": int(images.shape[0]), "batch_size": engine.batch_size,
        "chunks": chunks,
        "span_us": cost,
        "spans_per_chunk": len(spans) / chunks,
        "timed_launches_per_chunk": launches / chunks,
        "dropped": profiling.dropped(),
        "slice_ms": length_ms, "busy_ms": busy_ms,
        "device_idle": 1.0 - busy_ms / length_ms,
        "span_share": share_us / 1e3 / length_ms,
        "lead_in_ms": lead_ins_ms(spans),
        "idle_ms": length_ms - busy_ms,
        "gaps": gaps[:TOP],
        "idle_ms_by_span": idle_by_span(gaps),
        "dispatch_ms": statistics.mean(
            (s["end_ns"] - s["start_ns"]) / 1e6 for s in spans
            if s["name"] == "serve.dispatch"),
        "enqueue_ms": enqueue_ms(engine, device),
        "slice_ms_spans_on": paired[True],
        "slice_ms_spans_off": paired[False],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    engine = build_engine(args.preset, args.seed, resolve_device("cuda"))
    size = engine._img_size
    images = np.random.default_rng(args.seed).integers(
        0, 256, (IMAGES, size, size, 3), dtype=np.uint8)
    rep = report(engine, images, Path(args.out))
    with open(Path(args.out) / "report.json", "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
