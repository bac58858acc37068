"""Train state (port of ``protopformer_tpu/train/state.py``): the step
counter, the model, its optimizer and the EMA copy. There is no
GradScaler: the parameters are fp32 and bf16 needs no loss scaling."""

from __future__ import annotations

import copy
from typing import Optional

import torch

from protopformer_tpu_torch.core.device import resolve_device
from protopformer_tpu_torch.train.optimizer import GroupOptimizer


class TrainState:
    """``step`` (optimizer steps taken), ``model`` (updated in place),
    ``optimizer`` and ``ema`` (an eval-mode copy of the model, or None)."""

    def __init__(self, model: torch.nn.Module, optimizer: GroupOptimizer,
                 ema: Optional[torch.nn.Module] = None, step: int = 0):
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.ema = ema

    def apply_gradients(self, ema_decay: Optional[float] = None
                        ) -> "TrainState":
        """Update the parameters from their ``.grad`` at the schedules' LRs
        of this step, then ``ema = ema_decay * ema + (1 - ema_decay) *
        param`` (timm ``ModelEma``)."""
        self.optimizer.step(self.step)
        if self.ema is not None and ema_decay is not None:
            with torch.no_grad():
                ema = list(self.ema.parameters())
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, list(self.model.parameters()),
                                    alpha=1.0 - ema_decay)
        self.step += 1
        return self


def create_train_state(model: torch.nn.Module, tx: GroupOptimizer,
                       with_ema: bool = True, device="cuda") -> TrainState:
    """Move ``model`` (the one ``tx`` was made for) to ``device`` (CUDA
    unless the caller asks for the CPU; no CUDA device raises) and start
    at step 0, with an EMA copy of the weights."""
    model.to(resolve_device(device))
    ema = copy.deepcopy(model).eval() if with_ema else None
    if ema is not None:
        ema.requires_grad_(False)
    return TrainState(model, tx, ema)
