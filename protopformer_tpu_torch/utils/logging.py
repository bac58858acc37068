"""Logging and metric writers (port of ``protopformer_tpu/utils/logging.py``).

Replaces the reference's three channels (ref: main.py:209-238,
tools/utils.py:272-291): TensorBoard SummaryWriter, python file+console
logging, and print-gating by rank. Scalars always land in a JSONL file that
tooling can tail; TensorBoard is written beside it when
``torch.utils.tensorboard`` imports. The port runs one process, which is
rank 0 and always writes (several processes are ROADMAP.md Queue 1 item
13).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

_LOG_FORMAT = (
    "%(asctime)s - %(funcName)s - %(name)s - %(levelname)s - %(message)s"
)


def get_logger(
    name: str, output_dir: Optional[str] = None, file_name: str = "train.log"
) -> logging.Logger:
    """File + console logger (ref: tools/utils.py:272-291). A logger that
    already has handlers is returned as it is."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
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
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
