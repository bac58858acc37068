"""K1's share of its roofline in the traced slice (%), read from the
program's kernel-entry spans and not from kernel names: the least time the
launches could take (``counts.k1_bound_s`` of each
``fused_attention_block_stats`` span's batch and tokens, at the model's
width and discard mode) over the spans' device time: the CUDA event pairs
recorded around K1's launches themselves (one call that runs its heads
kernel and its select), so that the host's preparation before a launch,
which a device with nothing queued waits out, is not counted. None where
no K1 span took device time."""

from benchmark import counts, harness
from benchmark.spans import named, slice_spans


def read(record):
    spans = slice_spans(record)
    if not spans:
        return None
    k1 = [s for s in named(spans, "fused_attention_block_stats")
          if s["device_ms"] is not None]
    if not k1:
        return None
    cfg = harness.model_cfg(record["config"], "serve")
    bound_s = sum(counts.k1_bound_s(s["attrs"]["batch"], s["attrs"]["tokens"],
                                    cfg["embed_dim"],
                                    cfg["rollout_exact_discard"])
                  for s in k1)
    return 100.0 * bound_s / (sum(s["device_ms"] for s in k1) / 1e3)
