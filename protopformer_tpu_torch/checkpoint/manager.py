"""Epoch checkpoints: save, retention and resume (port of
``protopformer_tpu/checkpoint/manager.py``).

Orbax becomes one ``torch.save`` file a saved epoch,
``<directory>/checkpoint-<epoch>.pth``, holding the reference's keys
(ref: main.py:436-447): ``model`` and ``model_ema`` (state dicts),
``optimizer`` (the ``torch.optim`` state dict), ``lr_scheduler``
(``{"step": step}``: the schedules are indexed by the optimizer step),
``epoch`` and ``args`` (a plain dict, where the reference pickles an
``argparse.Namespace``), and beside them ``step``, the caller's ``extra``
entries (the JAX meta: ``val_acc1``, ``best``) and ``generator``: the state
of the ``torch.Generator`` the train step draws dropout and stochastic
depth from. A resume restores it, so a resumed run draws what a continuous
one draws (the JAX step folds the step into its key instead). Every entry
is a tensor or a plain container: the files load with
``torch.load(weights_only=True)``. There is no GradScaler (bf16 needs no
loss scaling).

Retention is Orbax's as the JAX package sets it: ``max_to_keep`` most
recent epochs; the best epoch is not protected.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from protopformer_tpu_torch.checkpoint.torch_convert import (
    load_torch_checkpoint,
    save_torch_checkpoint,
)
from protopformer_tpu_torch.train.state import TrainState

_FILE_RE = re.compile(r"^checkpoint-(\d+)\.pth$")
_STATE_KEYS = ("model", "model_ema", "optimizer", "lr_scheduler", "generator")


def epoch_of(path: str) -> Optional[int]:
    """The epoch of a manager's checkpoint file from its name, else None."""
    m = _FILE_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


def manager_for(path: str) -> Tuple["CheckpointManager", Optional[int]]:
    """(manager, epoch) of a checkpoint root (its latest epoch: None) or of
    one of its epoch files."""
    epoch = epoch_of(path)
    if os.path.isfile(path) and epoch is not None:
        return CheckpointManager(os.path.dirname(os.path.abspath(path))), epoch
    if os.path.isdir(path):
        return CheckpointManager(path), None
    raise FileNotFoundError(
        f"{path!r} is neither a checkpoint directory nor a "
        "checkpoint-<epoch>.pth file")


def _load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Epoch-granular checkpoints under ``directory``
    (ref: main.py:436-447 periodic saves, :460-471 epoch-best)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{epoch}.pth")

    def epochs(self) -> List[int]:
        return sorted(e for e in map(epoch_of, os.listdir(self.directory))
                      if e is not None)

    def save(
        self,
        epoch: int,
        state: TrainState,
        extra: Optional[Dict[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write epoch ``epoch`` (atomically: a temporary file, then a
        rename), then drop all but the ``max_to_keep`` latest epochs."""
        payload = {
            "model": state.model.state_dict(),
            "model_ema": (state.ema.state_dict() if state.ema is not None
                          else None),
            "optimizer": state.optimizer.optimizer.state_dict(),
            "lr_scheduler": {"step": state.step},
            "epoch": epoch,
            "step": state.step,
            "args": dict(args or {}),
            "generator": (generator.get_state() if generator is not None
                          else None),
            **(extra or {}),
        }
        path = self.path(epoch)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(
        self,
        state: TrainState,
        epoch: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> tuple:
        """Load epoch ``epoch`` (default: the latest) into ``state`` (its
        model, EMA, optimizer and step) and ``generator``; returns (state,
        meta): ``epoch``, ``args`` and the saved ``extra`` entries."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = _load(self.path(epoch))
        state.model.load_state_dict(payload["model"])
        if state.ema is not None:
            if payload["model_ema"] is None:
                raise ValueError(f"{self.path(epoch)} holds no EMA weights")
            state.ema.load_state_dict(payload["model_ema"])
        state.optimizer.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        if generator is not None and payload["generator"] is not None:
            generator.set_state(payload["generator"])
        meta = {k: v for k, v in payload.items() if k not in _STATE_KEYS}
        return state, meta


def save_params(path: str, model_or_state_dict) -> None:
    """One-shot weights-only save in the reference's ``{"model": ...}``
    layout (the offline tools load these, ref: main_visualize.py:287-291)."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    save_torch_checkpoint(path, sd)


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the weights of ``path`` strictly into ``model`` and return it.
    ``path`` is a ``.pth`` in the reference layout (``save_params``,
    ``cli.export``, the JAX package's ``main_export.py``), one of a
    manager's epoch files (its ``model``), or a manager's directory (its
    latest epoch's ``model``)."""
    if os.path.isdir(path):
        mgr, _ = manager_for(path)
        epoch = mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {mgr.directory}")
        path = mgr.path(epoch)
    model.load_state_dict(load_torch_checkpoint(path), strict=True)
    return model
