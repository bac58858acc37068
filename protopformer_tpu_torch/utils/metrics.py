"""Metric meters and timed iteration logging (the port's copy of
``protopformer_tpu/utils/metrics.py``): ``SmoothedValue`` windowed meters
and ``MetricLogger.log_every`` with an ETA. The values are host floats;
the train loop fetches them from the device once per window.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict

import numpy as np


class SmoothedValue:
    """Windowed + global average of a scalar stream
    (ref: tools/utils.py:35-94, minus the manual dist sync)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        value = float(value)
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def median(self) -> float:
        return float(np.median(self.window)) if self.window else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class MetricLogger:
    """Meter collection + timed iteration logging with ETA
    (ref: tools/utils.py:97-190)."""

    def __init__(self, delimiter: str = "  ", logger=None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{k}: {m}" for k, m in self.meters.items()
        )

    def _emit(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.info(msg)
        else:
            print(msg)

    def log_every(self, iterable, print_freq: int, header: str = ""):
        """Yield items, logging progress/ETA every ``print_freq`` steps."""
        total = len(iterable) if hasattr(iterable, "__len__") else None
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i - 1)
                    self._emit(
                        f"{header} [{i}/{total}] eta: {eta:.0f}s "
                        f"{self} time: {iter_time} data: {data_time}"
                    )
                else:
                    self._emit(f"{header} [{i}] {self} time: {iter_time}")
        self._emit(
            f"{header} total time: {time.time() - start:.1f}s"
        )

    def averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}
