"""The program's own spans of the traced slice, for the per-layer readers
that read them (``source`` ``program_span``).

The program records spans only while a profiler collects, and keeps those
of its newest profiler session (``protopformer_tpu_torch.utils.profiling``:
``spans()``). The traced slice is a run's last profile, so that session is
the slice. Each span is a dict: ``name``, ``id``, ``parent``, ``request``,
``start_ns`` and ``end_ns`` on the host's clock, ``attrs`` and
``device_ms`` (a kernel entry's span: the summed device time of the CUDA
event pairs its launches recorded around themselves, or None). Where the program records no spans (a program
without the accessor, or a record whose slice served no chunk), a reader
finds nothing and returns None."""

from __future__ import annotations

from typing import Iterable, List, Optional


def slice_spans(record: dict) -> Optional[List[dict]]:
    """The traced slice's spans, or None where there are none to read."""
    if not record["slice"].get("chunks"):
        return None
    try:
        from protopformer_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans() or None


def named(spans: List[dict], name: str) -> List[dict]:
    return [s for s in spans if s["name"] == name]


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def lead_ins_ms(spans: List[dict]) -> List[float]:
    """Per request, ms from its ``serve.request`` start to the start of its
    first ``serve.dispatch``."""
    first = {}
    for s in named(spans, "serve.dispatch"):
        r = s["request"]
        first[r] = min(first.get(r, s["start_ns"]), s["start_ns"])
    return [(first[s["request"]] - s["start_ns"]) / 1e6
            for s in named(spans, "serve.request") if s["request"] in first]
