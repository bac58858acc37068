"""Epoch loop (port of ``protopformer_tpu/train/loop.py``).

* the PPC epoch gate (``epoch >= ppc_start_epoch``) is a 0/1 multiplier;
* metric fetches are batched: the loop keeps each step's device metrics
  and copies a window of ``sync_every`` steps to the host in one
  synchronization, so the host keeps queueing steps in between;
* a non-finite loss raises ``NonFiniteLossError`` at the next fetch, at
  most ``sync_every - 1`` steps after the step that made it.

A loader has ``set_epoch(epoch)``, ``len`` and iterates over batches
``{"image", "label"[, "valid"]}``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from protopformer_tpu_torch.core.config import ExperimentConfig
from protopformer_tpu_torch.train.scheduler import make_group_schedules
from protopformer_tpu_torch.utils.metrics import MetricLogger


class NonFiniteLossError(RuntimeError):
    pass


def _fetch(metrics):
    """[{name: 0-d tensor}] -> [{name: float}] in one host copy."""
    flat = [torch.as_tensor(v).detach().float().reshape(())
            for m in metrics for v in m.values()]
    values = iter(torch.stack(flat).cpu().tolist()) if flat else iter(())
    return [{k: next(values) for k in m} for m in metrics]


def train_one_epoch(
    train_step,
    state,
    loader,
    epoch: int,
    generator,
    cfg: ExperimentConfig,
    writer=None,
    logger=None,
    global_iter: int = 0,
    sync_every: int = 20,
) -> tuple:
    """Run one training epoch; returns (state, stats, next_global_iter)."""
    metric_logger = MetricLogger(logger=logger)
    loader.set_epoch(epoch)
    ppc_gate = 1.0 if (cfg.ppnet.use_ppc_loss
                       and epoch >= cfg.ppnet.ppc_start_epoch) else 0.0
    steps_per_epoch = max(len(loader), 1)
    sched = make_group_schedules(cfg.optim, steps_per_epoch)
    metric_logger.update(lr=sched["features"](epoch * steps_per_epoch))

    it = global_iter
    pending = []  # (iter index, device metrics) awaiting one fetch

    def _drain():
        if not pending:
            return
        for (i, _), host in zip(pending, _fetch([m for _, m in pending])):
            if not math.isfinite(host["loss"]):
                raise NonFiniteLossError(
                    f"Loss is {host['loss']} at epoch {epoch} iter {i}, "
                    "stopping training"
                )
            metric_logger.update(**host)
            if writer is not None:
                writer.write(i, {f"train/{k}": v for k, v in host.items()})
        pending.clear()

    for batch in metric_logger.log_every(loader, 30,
                                         header=f"Epoch: [{epoch}]"):
        # the eval-only valid mask is dropped (train drops ragged batches)
        batch = {"image": batch["image"], "label": batch["label"]}
        state, metrics = train_step(state, batch, generator, ppc_gate)
        pending.append((it, metrics))
        if len(pending) >= max(1, sync_every):
            _drain()
        it += 1
    _drain()

    stats = metric_logger.averages()
    if logger is not None:
        logger.info(f"Averaged stats: {metric_logger}")
    return state, stats, it


def evaluate(eval_step, model, loader, logger=None,
             use_global: bool = True) -> Dict[str, float]:
    """Evaluation over the whole loader, aggregated exactly over a padded
    last batch through its valid mask."""
    totals: Dict[str, float] = {}
    for batch in loader:
        for k, v in _fetch([eval_step(model, batch)])[0].items():
            totals[k] = totals.get(k, 0.0) + v
    n = max(totals.pop("n", 0.0), 1.0)
    out = {
        "loss": totals.get("loss_sum", 0.0) / n,
        "acc1": 100.0 * totals.get("correct1", 0.0) / n,
        "acc5": 100.0 * totals.get("correct5", 0.0) / n,
    }
    if use_global and "global_correct1" in totals:
        out["global_acc1"] = 100.0 * totals["global_correct1"] / n
        out["local_acc1"] = 100.0 * totals["local_correct1"] / n
    if logger is not None:
        logger.info(f"* Acc@1 {out['acc1']:.3f} Acc@5 {out['acc5']:.3f} "
                    f"loss {out['loss']:.3f}")
    return out
