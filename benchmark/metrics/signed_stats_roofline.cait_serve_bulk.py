"""The signed discard search's share of its roofline in the traced slice
(%): the least time the program's ``cait.signed_stats`` regions could take
(``counts.cait.signed_stats_bound_s`` of each span's batch, tokens and
stored map dtype: the map read once, the threshold and the row sums
written once) over the device time the spans timed (one CUDA event pair
around each region's work). None where no such span took device time, as
in a program without the span."""

from benchmark.counts import cait
from benchmark.spans import named, slice_spans


def read(record):
    spans = slice_spans(record)
    if not spans:
        return None
    st = [s for s in named(spans, "cait.signed_stats")
          if s["device_ms"] is not None]
    if not st:
        return None
    bound_s = sum(cait.signed_stats_bound_s(
        s["attrs"]["batch"], s["attrs"]["tokens"], s["attrs"]["map_dtype"])
        for s in st)
    return 100.0 * bound_s / (sum(s["device_ms"] for s in st) / 1e3)
