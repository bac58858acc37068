"""The data-parallel device mesh (port of
``protopformer_tpu/parallel/mesh.py``).

The reference's only parallelism is data-parallel DDP over NCCL (ref:
main.py:370, tools/utils.py:247-269). The JAX package states it as a 1-D
``jax.sharding.Mesh`` with the batch sharded on its ``data`` axis and the
parameters replicated. Here a mesh is the ordered list of devices of one
process: ``shard_batch`` splits a batch's leading axis into one contiguous
slice a device (device d gets rows d*b .. (d+1)*b - 1, as ``P("data")``
lays them out), and ``replicate`` puts one copy of a module on each device.
The serving engine and the consistency score run one replica a device over
those slices; training runs one process a card under
``torch.distributed`` (``parallel/multihost.py``), not a mesh.

``make_mesh()`` takes every visible CUDA device and raises without one. CPU
devices are used only when listed; the tests list one CPU device several
times, as the JAX tests use 8 virtual CPU devices.

``replicated_sharding``/``batch_sharding`` only named XLA placements; what
they placed is ``replicate``'s and ``shard_batch``'s work here.
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from protopformer_tpu_torch.core.device import resolve_device


class Mesh:
    """A 1-D data-parallel mesh: ``devices`` in order, ``axis_name`` and
    ``size``. A device may appear more than once (replicas sharing it)."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_name: str = "data"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return f"Mesh({self.axis_name}: [{names}])"


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh over the given devices, by default every
    visible CUDA device (none raises)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis_name)


def _split(x, mesh: Mesh) -> List[torch.Tensor]:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if t.shape[0] % mesh.size:
        raise ValueError(
            f"a batch of {t.shape[0]} rows does not split into {mesh.size} "
            "equal slices"
        )
    b = t.shape[0] // mesh.size
    return [t[d * b:(d + 1) * b].to(dev, non_blocking=True)
            for d, dev in enumerate(mesh.devices)]


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """Split the leading axis of a batch (an array, or a dict of arrays)
    into ``mesh.size`` equal contiguous slices, each moved to its device.
    Returns one slice a device, in mesh order; a leading axis that does
    not divide evenly raises."""
    if isinstance(batch, dict):
        parts = {k: _split(v, mesh) for k, v in batch.items()}
        return [{k: v[d] for k, v in parts.items()}
                for d in range(mesh.size)]
    return _split(batch, mesh)


def replicate(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One copy of ``module`` on each mesh device (its train/eval mode
    kept); the copies share nothing."""
    return [copy.deepcopy(module).to(dev) for dev in mesh.devices]
