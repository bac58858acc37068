"""The gated FFN's share of its roofline in the traced slice (%): the
least time the program's ``dinov2.swiglu`` regions could take
(``counts.dinov2.swiglu_bound_s`` of each span's batch, tokens, width and
hidden width) over the device time the spans timed (one CUDA event pair
around each region's ``w12``, gate and ``w3``). None where no such span
took device time, as in a program without the span."""

from benchmark.counts import dinov2
from benchmark.spans import named, slice_spans


def read(record):
    spans = slice_spans(record)
    if not spans:
        return None
    ffn = [s for s in named(spans, "dinov2.swiglu")
           if s["device_ms"] is not None]
    if not ffn:
        return None
    bound_s = sum(dinov2.swiglu_bound_s(
        s["attrs"]["batch"], s["attrs"]["tokens"], s["attrs"]["dim"],
        s["attrs"]["hidden"]) for s in ffn)
    return 100.0 * bound_s / (sum(s["device_ms"] for s in ffn) / 1e3)
