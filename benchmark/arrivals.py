"""The one traffic generator: requests drawn from a mix's parameters and
the run's seed.

A serving mix gives the request sizes as ``[least, most]`` images. Sizes
come in cycles that hold every size of that range once, each cycle in an
order of its own drawn from the seed, so every seed sends the same sizes
and only their order and the images differ. Each request is a contiguous
run of the host image pool, starting at an offset drawn from the seed.
The loop is closed: one client sends its next request when the last one
has returned.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from benchmark.weights import sub_seed


def requests(traffic: dict, seed: int) -> Iterator[Tuple[int, int]]:
    """Endless (offset, size) pairs into a pool of ``pool_images``."""
    least, most = traffic["sizes"]
    pool = traffic["pool_images"]
    if not 1 <= least <= most <= pool:
        raise ValueError(f"sizes {traffic['sizes']} do not fit a pool of "
                         f"{pool} images")
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    while True:
        for size in rng.permutation(np.arange(least, most + 1)):
            size = int(size)
            yield int(rng.integers(0, pool - size + 1)), size
