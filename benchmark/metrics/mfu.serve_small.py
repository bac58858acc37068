"""The pruned forward's operations (``counts.forward_flops``) for the real
images served in the window, over the window, as a share of the card's
bf16 peak (%): padding rows are not counted, so padding shows."""

from benchmark import counts
from benchmark.readers import mfu


def read(record):
    return mfu(record, "serve", counts.forward_flops)
