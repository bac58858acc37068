"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

Each kernel's CUDA wrapper adds one to the counter
``launches.<kernel name>`` of ``utils/profiling.py``'s registry where it
launches the kernel; ``launch_counts`` reads those counters and
``reset_launch_counts`` sets them to 0. Each public entry opens a span
named after it on its operand (``profiling.span``), recorded while a
profiler collects, whose device time is that of the launches inside it;
K1's encloses its heads kernel and its select.

No kernel fixes a most token count: each launcher picks a route by the
shape alone (no entry point, argument or flag lets a caller choose
another), as the JAX kernels take any N. Up to 256 tokens K1 and K3 keep a
head's keys in shared memory and registers; from 257 on their long kernels
stream them through shared memory in chunks, and the selects of K1, K2 and
K4/K5's normalize split one sample over a cluster of up to 16 CTAs (a
non-portable size above 512 rows). Above 640 tokens the long kernels keep
their head-mean accumulators (and K3 fp32 its P) in device memory, and
where a band of fp32 map rows no longer fits a CTA's shared memory (from
~850 tokens) the select reads the band where the map lies. What limits N
then is a block's 232,448 bytes of shared memory, which the wrappers check
(K1's heads kernel to ~6,000 tokens, K3's bf16 long kernel to ~2,900), and
the card's memory for the maps. Bounds
at B=160, N=577, H=12, hd=64 on an H100 (bytes at 3.35 TB/s, operations
at 989 TFLOP/s bf16 or 67 TFLOP/s fp32): K1 674 MB (speed) / 780 MB
(exact), 0.201 / 0.233 ms; K2 213 MB, 0.064 ms; K3 fp32 164 GFLOP,
2.44 ms.

Beside the five ports, ``activation.gelu_tanh_cuda`` (``csrc/gelu.cu``)
runs the bf16 MLP's tanh GELU in one pass with the eager chain's bits,
where ``ops.activations.gelu_speed`` gets a CUDA bf16 tensor that needs no
gradient. It ports no JAX kernel, so it is not in ``WRAPPERS`` nor in
``launch_counts``; it counts ``launches.gelu_tanh`` (and ``gelu_speed``
counts ``gelu.plain`` where a CUDA tensor takes the chain), 12 and 0 a
served bf16 chunk. Bound: bytes, the hidden read and written once (1.134
GB at B=160 for DeiT-B/16@384, 0.339 ms). Likewise
``talking_heads.talking_heads_cuda`` (``csrc/talking_heads.cu``) runs
CaiT's talking-heads attention (QK^T, both head mixes, the softmax, PV and
the fused head map) in one launch, where ``ops.talking_heads`` gets a CUDA
bf16 qkv that needs no gradient at 4 or 8 heads of 48; it counts
``launches.talking_heads`` (and the chain ``talking_heads.plain`` on the
card), 24 and 0 a served bf16 CaiT chunk. Bound: bytes, qkv read and the
output and bf16 map written once (389 MB at B=160 for CaiT-S24@384, 0.116
ms). And ``stats.signed_map_stats_cuda`` (``csrc/map_stats.cu``'s select in
the signed key space) runs CaiT's discard search and masked row sums of a
whole square map in one launch, where ``ops.rollout.masked_map_stats``
gets ``signed=True`` and a CUDA map; it counts ``launches.signed_map_stats``
(and the bisection chain ``signed_stats.plain`` on the card), 24 and 0 a
served CaiT chunk. Bound: bytes, the map read once and t and s written
once (106.5 MB at B=160 for CaiT-S24@384's bf16 maps, 0.0318 ms).
"""

from typing import Dict

from protopformer_tpu_torch.kernels.attention_core import (
    block_stats_cuda,
    core_cuda,
    core_padded_cuda,
    fused_attention_block_stats,
    fused_attention_core,
    fused_attention_core_padded,
    fused_attention_mean_padded,
    mean_padded_cuda,
)
from protopformer_tpu_torch.kernels.stats import (
    fused_map_stats,
    map_stats_cuda,
)
from protopformer_tpu_torch.utils import profiling

# kernel name (the JAX function it ports) -> its CUDA wrapper
WRAPPERS = {
    "fused_attention_block_stats": block_stats_cuda,
    "fused_map_stats": map_stats_cuda,
    "fused_attention_mean_padded": mean_padded_cuda,
    "fused_attention_core": core_cuda,
    "fused_attention_core_padded": core_padded_cuda,
}


def launch_counts() -> Dict[str, int]:
    got = profiling.counts("launches.")
    return {name: got.get(f"launches.{name}", 0) for name in WRAPPERS}


def reset_launch_counts() -> None:
    profiling.reset_counts("launches.")


__all__ = [
    "WRAPPERS",
    "fused_attention_block_stats",
    "fused_attention_core",
    "fused_attention_core_padded",
    "fused_attention_mean_padded",
    "fused_map_stats",
    "launch_counts",
    "reset_launch_counts",
]
