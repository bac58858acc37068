"""Tracing and profiling hooks (port of
``protopformer_tpu/utils/profiling.py``).

The reference has no profiler; its closest machinery is MetricLogger's
wall-clock timing and CUDA max-memory. Here:

  * ``trace(log_dir)``: ``torch.profiler.profile`` over the CPU and, on
    the card, CUDA activities, writing a TensorBoard/Chrome trace
    (``<worker>.<time>.pt.trace.json``) into ``log_dir``; with no
    directory it does nothing;
  * ``span(name, ...)``: a named span of the program, recorded only while
    a ``torch.profiler`` session collects (below), and ``launch_events``,
    which the kernel launchers call to time their launches inside it;
  * ``count(name, n)`` / ``counts()`` / ``reset_counts()``: a registry of
    plain integer counters, always on (the kernels' launches, the serving
    engine's requests, chunks, rows and bytes);
  * ``device_memory_stats()``: each CUDA device's ``torch.cuda.memory_stats``
    byte counters in MiB, keyed by device.

Spans. With no profiler collecting, ``span`` reads one flag
(``torch.autograd.profiler._is_profiler_enabled``) and returns a shared
do-nothing context: no ``record_function`` is entered, nothing is
allocated and no CUDA event is recorded. While a profiler collects, a span

  * enters a ``record_function`` of its name, so it shows in every
    exported trace and the kernels launched under it correlate to it;
  * appends a record to a bounded buffer (``MAX_SPANS`` records a session;
    the rest are counted in ``dropped()``): its name, id, the id of the
    span it opened under on this thread (``parent``), the request id
    (given, or the parent's), its start and end from ``time.time_ns()``
    (the clock Kineto stamps its host and device records on, so no
    conversion is needed), its attributes and the profiler session;
  * given a kernel entry's CUDA operand, times the kernel launches made
    inside it: each launcher records a CUDA event pair on its stream
    around the launch itself (``launch_events``; none while the stream is
    being captured into a graph), and ``spans()`` sums the pairs'
    elapsed times into ``device_ms`` once they have completed. The host's
    preparation before a launch lies outside every pair, so a device left
    waiting for it does not count as the kernel's time;
  * given a ``region`` tensor on the card instead, times the region's
    whole work (plain PyTorch, no kernel entry): one CUDA event pair on
    the current stream, its start recorded as the span opens and its end
    as it closes, whose elapsed time is ``device_ms``: from the end of the
    work enqueued on that stream before the span to the end of the work
    enqueued inside it. Where the host enqueues the region slower than the
    device runs it, the device's waits inside count too.

A session is one collecting period of a profiler (each start of a
``torch.profiler.profile``, or of each recording phase of its schedule);
the buffer keeps the newest session's spans. A session opens through
``torch.autograd.profiler._run_on_profiler_start``, which the profiler
calls as it starts; on a torch without that call ``spans()`` raises rather
than mix sessions. There is no switch of its own: tracing is on exactly
when a profiler is on.

``trace`` and ``device_memory_stats`` run on the card unless the caller
asks for the CPU; with no CUDA device the default raises.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from protopformer_tpu_torch.core.device import resolve_device

MAX_SPANS = 1 << 16  # records kept a session


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


# --- counters ---------------------------------------------------------------

_COUNTS: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix``."""
    return {k: v for k, v in _COUNTS.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Set the counters whose names start with ``prefix`` to 0."""
    for k in counts(prefix):
        _COUNTS[k] = 0


# --- spans ------------------------------------------------------------------

class _Sessions:
    """The span buffer: the newest profiler session's records."""

    def __init__(self):
        self.session = 0
        self.records: List[dict] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def start(self) -> None:
        self.session += 1
        self.records = []
        self.dropped = 0

    def stack(self) -> List[dict]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def append(self, rec: dict) -> None:
        if rec["session"] != self.session:
            return  # opened in an earlier session
        if len(self.records) >= MAX_SPANS:
            self.dropped += 1
        else:
            self.records.append(rec)


_SESSIONS = _Sessions()


def _install_session_hook() -> bool:
    """Open a new session at each start of a profiler: the profiler calls
    ``torch.autograd.profiler._run_on_profiler_start`` as it starts
    collecting. False where this torch has no such call."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if start is None:
        return False
    if getattr(start, "opens_span_sessions", False):
        return True

    def on_start():
        _SESSIONS.start()
        start()

    on_start.opens_span_sessions = True
    _autograd_profiler._run_on_profiler_start = on_start
    return True


_HOOKED = _install_session_hook()


class _Off:
    """The span while no profiler collects: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "rf", "stream")

    def __init__(self, name: str, operand, request, attrs, region):
        self.rec = {"name": name, "request": request, "attrs": {},
                    "launches": None, "region": None}
        self.stream = None
        if operand is not None:
            self.rec["attrs"] = {
                "batch": operand.shape[0], "tokens": operand.shape[1],
                "route": "cuda" if operand.is_cuda else "plain"}
            if operand.is_cuda:
                self.rec["launches"] = []
        if attrs:
            self.rec["attrs"].update(attrs)
        if (region is not None and region.is_cuda
                and not torch.cuda.is_current_stream_capturing()):
            self.stream = torch.cuda.current_stream(region.device)

    def __enter__(self):
        rec = self.rec
        stack = _SESSIONS.stack()
        parent = stack[-1] if stack else None
        rec["id"] = next(_SESSIONS.ids)
        rec["parent"] = parent["id"] if parent else None
        if rec["request"] is None and parent is not None:
            rec["request"] = parent["request"]
        rec["session"] = _SESSIONS.session
        self.rf = _autograd_profiler.record_function(rec["name"])
        self.rf.__enter__()
        stack.append(rec)
        rec["start_ns"] = time.time_ns()
        if self.stream is not None:
            rec["region"] = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            rec["region"][0].record(self.stream)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec["region"] is not None:
            rec["region"][1].record(self.stream)
        rec["end_ns"] = time.time_ns()
        _SESSIONS.stack().pop()
        self.rf.__exit__(*exc)
        _SESSIONS.append(rec)
        return False


def span(name: str, operand: Optional[torch.Tensor] = None,
         request: Optional[int] = None, attrs: Optional[dict] = None,
         region: Optional[torch.Tensor] = None):
    """A named span of the program (a context manager), recorded only while
    a profiler collects. ``request`` is the request id (else the enclosing
    span's). ``operand`` marks a kernel entry's span: its (B, N, ...)
    operand gives the attributes ``batch`` B, ``tokens`` N and ``route``
    (``cuda`` or ``plain``), and on the CUDA route the span times the
    kernel launches made inside it (``launch_events``). ``attrs`` are
    further attributes. ``region``, a tensor of the region's work, marks a
    region's span: on the card (and not while its stream is captured into
    a graph) one event pair around the body times the region's device
    work on the current stream."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, operand, request, attrs, region)


def launch_events(stream) -> Optional[tuple]:
    """Called by a kernel launcher just before it launches on ``stream``,
    the current stream of the current device. Where a profiler collects,
    the innermost open span on this thread is a CUDA kernel entry's and the
    stream is not being captured into a graph, records the start event of
    a timing pair on the stream, adds the pair to the span and returns it:
    the launcher records its end event just after the launch. Else None.
    The pair holds only the launch: the host's work before it (output
    allocation, shape checks) stays outside the span's device time."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    stack = _SESSIONS.stack()
    if (not stack or stack[-1]["launches"] is None
            or torch.cuda.is_current_stream_capturing()):
        return None
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pair[0].record(stream)
    stack[-1]["launches"].append(pair)
    return pair


def spans() -> List[dict]:
    """The newest profiler session's spans in the order they ended, each a
    dict of ``name``, ``id``, ``parent``, ``request``, ``session``,
    ``start_ns``, ``end_ns``, ``attrs``, ``timed_launches`` (the kernel
    launches a kernel entry's span timed) and ``device_ms`` (their summed
    device time, or a region's, None where it timed nothing). Waits for
    those events. Raises where this torch gives no call at a profiler's
    start, so that sessions cannot be told apart."""
    if not _HOOKED:
        raise RuntimeError(
            "torch.autograd.profiler has no _run_on_profiler_start in this "
            "torch: the spans of one profiler session cannot be told from "
            "another's")
    out = []
    for rec in _SESSIONS.records:
        if "launches" in rec:  # not yet resolved
            launches = rec.pop("launches") or []
            region = rec.pop("region")
            pairs = [region] if region is not None else launches
            if pairs:  # one stream: the last pair ends last
                pairs[-1][1].synchronize()
            rec["device_ms"] = (sum(a.elapsed_time(b) for a, b in pairs)
                                if pairs else None)
            rec["timed_launches"] = len(launches)
        out.append(dict(rec, attrs=dict(rec["attrs"])))
    return out


def dropped() -> int:
    """Spans of the newest session that did not fit the buffer."""
    return _SESSIONS.dropped


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
