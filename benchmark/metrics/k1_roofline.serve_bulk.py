"""K1's share of its roofline in the traced slice (%): the least time its
launches could take (``counts.k1_bound_s``: contract bytes over the
memory rate, or operations over the bf16 peak, the larger, each launch at
the chunk's batch and the model's tokens and width) over the device time
of the kernels K1's launches run.

K1 (``fused_attention_block_stats``) runs one of the names below: up to 256
tokens its one kernel, above that its heads kernel (the long or, past 640
tokens, the head-split one) and then its select, which is K2's kernel
launched on K1's stored map. That name is K2's too, so where K2 launched
on its own in the slice the time cannot be told apart and nothing is
read. Where K1 is off the path nothing is read either. Where K1 launched
and none of its kernels' names is in the slice, its kernels were renamed
or a route was added: the reader raises rather than let the metric fall
silent."""

import re

from benchmark import counts, harness

K1_KERNELS = re.compile(
    r"\b(block_stats_kernel|block_stats_long_kernel|block_stats_split_kernel"
    r"|map_stats_kernel)\b")


def read(record):
    s = record["slice"]
    launches = s["launches"]
    n_k1 = launches.get("fused_attention_block_stats", 0)
    if not n_k1 or launches.get("fused_map_stats", 0):
        return None
    k1_s = sum(end - start for name, start, end in s["ops"]
               if K1_KERNELS.search(name)) / 1e6
    if not k1_s:
        raise RuntimeError(
            f"K1 launched {n_k1} times in the traced slice, and no device "
            f"operation there matches {K1_KERNELS.pattern}")
    cfg = harness.model_cfg(record["config"], "serve")
    tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    bound = n_k1 * counts.k1_bound_s(
        record["window"]["chunk"], tokens, cfg["embed_dim"],
        cfg["rollout_exact_discard"])
    return 100.0 * bound / k1_s
