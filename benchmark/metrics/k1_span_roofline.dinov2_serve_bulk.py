"""K1's share of its roofline in the DINOv2 cell's traced slice (%):
``k1_span_roofline.serve_bulk``'s own reader (``counts.k1_bound_s`` of
each ``fused_attention_block_stats`` span over the spans' device time),
read in this cell. None where no K1 span took device time."""

from benchmark import harness

_SERVE_BULK = harness.load_module(
    harness.BENCH / "metrics" / "k1_span_roofline.serve_bulk.py")


def read(record):
    return _SERVE_BULK.read(record)
