"""Multi-group optimizer (port of ``protopformer_tpu/train/optimizer.py``).

The reference builds three parameter groups, each with its own LR: the
backbone features and the add-on layers (weight decay
``group_weight_decay``), and the local and global prototype vectors
(weight decay ``weight_decay``, 0.05 by default). The frozen class-identity
heads and ``ones`` are in no group. Here the groups are ``torch.optim``
param groups named by ``param_group_label``; before each step their LRs
are set from the epoch-staircase schedules.

* ``adamw``: ``torch.optim.AdamW``, decoupled decay, the same update as
  optax's ``adamw``;
* ``adam``: ``torch.optim.Adam`` with decay as L2 in the gradient
  (optax: ``add_decayed_weights`` before ``adam``);
* ``sgd`` and ``nesterov``: ``torch.optim.SGD`` with Nesterov momentum for
  both spellings, as the reference does, decay as L2.

``clip_grad`` clips the global norm of the trainable parameters' gradients
(``torch.nn.utils.clip_grad_norm_``), as the reference does. The JAX
package clips before its group split, so its norm also counts the frozen
heads' gradients; the port follows the reference (ROADMAP Queue 3, F8).
"""

from __future__ import annotations

from typing import Dict

import torch

from protopformer_tpu_torch.core.config import OptimConfig
from protopformer_tpu_torch.train.scheduler import (
    Schedule,
    make_group_schedules,
)

GROUPS = ("features", "add_on", "prototypes")


def param_group_label(name: str) -> str:
    """A parameter's group from its module name: ``features.*``,
    ``add_on_layers.*``, the prototype vectors, or ``frozen`` (``ones`` and
    the class-identity heads). Other roots train with the features."""
    root = name.split(".")[0]
    if root == "add_on_layers":
        return "add_on"
    if root in ("prototype_vectors", "prototype_vectors_global"):
        return "prototypes"
    if root in ("ones", "last_layer", "last_layer_global"):
        return "frozen"
    return "features"


class GroupOptimizer:
    """A ``torch.optim`` optimizer over the named groups, their schedules
    and the gradient clip."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedules: Dict[str, Schedule], clip_grad=None):
        self.optimizer = optimizer
        self.schedules = schedules
        self.clip_grad = clip_grad

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, step: int) -> None:
        """One update at optimizer step ``step`` (it sets the group LRs)."""
        groups = self.optimizer.param_groups
        for group in groups:
            group["lr"] = self.schedules[group["name"]](step)
        if self.clip_grad is not None:
            torch.nn.utils.clip_grad_norm_(
                [p for g in groups for p in g["params"]], self.clip_grad)
        self.optimizer.step()


def make_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                   steps_per_epoch: int) -> GroupOptimizer:
    """The optimizer over ``model``'s trainable groups."""
    decay = {"features": cfg.group_weight_decay,
             "add_on": cfg.group_weight_decay,
             "prototypes": cfg.weight_decay}
    params = {name: [] for name in GROUPS}
    for name, p in model.named_parameters():
        label = param_group_label(name)
        if label != "frozen":
            params[label].append(p)
    groups = [{"params": params[name], "name": name,
               "weight_decay": decay[name], "lr": 0.0}
              for name in GROUPS if params[name]]
    betas = tuple(cfg.opt_betas)
    if cfg.opt == "adamw":
        opt = torch.optim.AdamW(groups, betas=betas, eps=cfg.opt_eps)
    elif cfg.opt == "adam":
        opt = torch.optim.Adam(groups, betas=betas, eps=cfg.opt_eps)
    elif cfg.opt in ("sgd", "nesterov"):
        opt = torch.optim.SGD(groups, lr=0.0, momentum=cfg.momentum,
                              nesterov=True)
    else:
        raise ValueError(f"unknown opt: {cfg.opt}")
    return GroupOptimizer(opt, make_group_schedules(cfg, steps_per_epoch),
                          cfg.clip_grad)
