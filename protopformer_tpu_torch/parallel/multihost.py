"""Several processes, one card each (port of
``protopformer_tpu/parallel/multihost.py``).

The reference bootstraps NCCL from the environment (ref: tools/utils.py:
247-269 ``init_distributed_mode``) and shards its data with
DistributedSampler (ref: main.py:286-297). Here:

  * ``initialize_multihost`` calls ``torch.distributed.init_process_group``
    from ``env://`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them) or from explicit
    arguments; a world of one process does nothing. The backend is the
    caller's: "nccl" by default, "gloo" when asked for (the CPU tests, or
    two ranks sharing one card, which NCCL refuses). Nothing picks gloo
    because NCCL failed;
  * ``shard_index_for_process`` is each process's shard of a sample index,
    the JAX package's interleaved arithmetic; with ``even=True`` the last
    samples wrap around so every process has the same count, and the
    wrapped duplicates carry ``valid`` 0 so an evaluation counts each
    sample once;
  * ``assemble_global_batch`` puts the process's local batch on its card.
    Under DistributedDataParallel the global view is the gradient
    all-reduce plus an all-reduce of the metrics (``train/steps.py``), so
    nothing is gathered.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from protopformer_tpu_torch.data.datasets import DatasetIndex


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> bool:
    """Join the process group (a no-op for one process or when already
    joined). Arguments left as None come from the environment
    (``WORLD_SIZE``, ``RANK``; the address from ``MASTER_ADDR`` and
    ``MASTER_PORT``); ``coordinator_address`` is "host:port" or a URL
    (``tcp://``, ``env://``). Returns whether a group of several processes
    is up."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes == 1:
        return False
    if dist.is_initialized():
        return True
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "the nccl backend needs CUDA and no CUDA device is available; "
            "pass backend='gloo' to run the processes on the CPU"
        )
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's card on its host (``LOCAL_RANK``, 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


# the shard function's arguments share these names
_process_index, _process_count = process_index, process_count


def is_main_process() -> bool:
    """Print and checkpoint gating (ref: tools/utils.py:203-215, 242-244)."""
    return process_index() == 0


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def assemble_global_batch(local_batch: Dict[str, Any], device
                          ) -> Dict[str, torch.Tensor]:
    """This process's LOCAL batch (its rows of the global batch) as
    tensors on its card. Nothing is gathered: the data-parallel step
    all-reduces the gradients and the metrics instead."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device, non_blocking=True)
        for k, v in local_batch.items()}


def shard_index_for_process(
    index: DatasetIndex,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    even: bool = True,
) -> DatasetIndex:
    """Per-process shard of a dataset index (DistributedSampler's
    equivalent, ref: main.py:286-288): process p takes samples p, p + n,
    p + 2n, ... With ``even=True`` every process gets ceil(total / n)
    samples, the last ones wrapping around to the start; those wrapped
    duplicates have ``valid`` 0."""
    p = _process_index() if process_index is None else process_index
    n = _process_count() if process_count is None else process_count
    if n == 1:
        return index
    total = len(index)
    if even:
        per = (total + n - 1) // n
        raw = np.arange(per) * n + p
        ids = raw % total
        valid = (raw < total).astype(np.float32)
    else:
        ids = np.arange(p, total, n)
        valid = np.ones(len(ids), np.float32)
    if index.valid is not None:
        valid = valid * index.valid[ids]
    return DatasetIndex(
        paths=[index.paths[i] for i in ids],
        labels=index.labels[ids],
        num_classes=index.num_classes,
        image_ids=(
            index.image_ids[ids] if index.image_ids is not None else None
        ),
        images=index.images[ids] if index.images is not None else None,
        crop_boxes=(
            index.crop_boxes[ids] if index.crop_boxes is not None else None
        ),
        valid=valid,
    )
