"""The CaiT PPNet forward's operations (``counts.cait.forward_flops``) for
the real images served in the window, over the window, as a share of the
card's bf16 peak (%): padding rows are not counted, so padding shows.
None for a configuration without class-attention blocks (not a CaiT)."""

from benchmark.counts import cait
from benchmark.readers import mfu


def read(record):
    if "depth_token_only" not in record["config"]["backbone"]:
        return None
    return mfu(record, "serve", cait.forward_flops)
