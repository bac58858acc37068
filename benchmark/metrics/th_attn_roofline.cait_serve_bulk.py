"""The talking-heads attention's share of its roofline in the traced slice
(%): the least time the program's ``cait.talking_heads`` regions could
take (``counts.cait.talking_heads_bound_s`` of each span's batch, tokens,
heads, head width and stored map dtype) over the device time the spans
timed (one CUDA event pair around each region's work). None where no such
span took device time, as in a program without the span."""

from benchmark.counts import cait
from benchmark.spans import named, slice_spans


def read(record):
    spans = slice_spans(record)
    if not spans:
        return None
    th = [s for s in named(spans, "cait.talking_heads")
          if s["device_ms"] is not None]
    if not th:
        return None
    bound_s = sum(cait.talking_heads_bound_s(
        s["attrs"]["batch"], s["attrs"]["tokens"], s["attrs"]["heads"],
        s["attrs"]["head_dim"], s["attrs"]["map_dtype"]) for s in th)
    return 100.0 * bound_s / (sum(s["device_ms"] for s in th) / 1e3)
