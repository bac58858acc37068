"""Logging and metric writers (port of ``protopformer_tpu/utils/logging.py``).

Replaces the reference's three channels (ref: main.py:209-238,
tools/utils.py:272-291): TensorBoard SummaryWriter, python file+console
logging, and print-gating by rank. Scalars always land in a JSONL file that
tooling can tail; TensorBoard is written beside it when
``torch.utils.tensorboard`` imports. In a data-parallel run only rank 0
of the ``torch.distributed`` group logs and writes, as the JAX package
gates on process 0; one process is rank 0.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import torch.distributed as dist

_LOG_FORMAT = (
    "%(asctime)s - %(funcName)s - %(name)s - %(levelname)s - %(message)s"
)


def _is_rank0() -> bool:
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def get_logger(
    name: str, output_dir: Optional[str] = None, file_name: str = "train.log"
) -> logging.Logger:
    """File + console logger (ref: tools/utils.py:272-291); emits on rank 0
    only (ref print-gating: utils.py:203-215). A logger that already has
    handlers is returned as it is."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    if not _is_rank0():
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter(_LOG_FORMAT)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, file_name))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """Scalar writer: always ``metrics.jsonl``, TensorBoard if available.

    Mirrors the reference's per-iteration train scalars + per-epoch val
    scalars (ref: tools/engine_proto.py:86-107, main.py:432,452-457)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self._jsonl = self._tb = None
        if not _is_rank0():
            return
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(
            os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1
        )
        try:  # optional TB backend
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(
                log_dir=os.path.join(output_dir, "tf-logs"), flush_secs=1
            )

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if self._jsonl is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        if self._jsonl is None:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
