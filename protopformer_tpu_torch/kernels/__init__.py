"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

Each kernel's wrapper keeps a plain integer ``launches`` counter that it
raises by one where it launches the kernel; ``launch_counts`` reads them
and ``reset_launch_counts`` sets them to 0.
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
from protopformer_tpu_torch.kernels.stats import fused_map_stats, map_stats_cuda

# kernel name (the JAX function it ports) -> its CUDA wrapper
WRAPPERS = {
    "fused_attention_block_stats": block_stats_cuda,
    "fused_map_stats": map_stats_cuda,
    "fused_attention_mean_padded": mean_padded_cuda,
    "fused_attention_core": core_cuda,
    "fused_attention_core_padded": core_padded_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


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
