"""The DINOv2-register PPNet forward's operations
(``counts.dinov2.forward_flops``) for the real images served in the
window, over the window, as a share of the card's bf16 peak (%): padding
rows are not counted, so padding shows. None for a configuration without
register tokens (not a DINOv2 one)."""

from benchmark.counts import dinov2
from benchmark.readers import mfu


def read(record):
    if "num_register_tokens" not in record["config"]["backbone"]:
        return None
    return mfu(record, "serve", dinov2.forward_flops)
