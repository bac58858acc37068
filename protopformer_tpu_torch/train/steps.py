"""Train and eval steps (port of ``protopformer_tpu/train/steps.py``).

One train step: the ImageNet normalize of the [0, 1] batch on the device,
the train forward, cross-entropy, the PPC losses times the 0/1
``ppc_gate`` (the epoch gate, a multiplier so both values run one
program), the backward, the optimizer update and the EMA. There is no
autocast and no GradScaler: parameters stay fp32 and each product runs in
the model's compute dtype. An fp32 model on CUDA runs with TF32 off
(``serving.no_tf32``), so fp32 is true fp32.

Both factories run on CUDA unless the caller passes ``device="cpu"``; with
no CUDA device the default raises. Metrics come back as 0-d device tensors
that are not synchronized: the loop fetches them once per window.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from protopformer_tpu_torch.core.config import OptimConfig, PPNetConfig
from protopformer_tpu_torch.core.device import resolve_device
from protopformer_tpu_torch.data.mixup import MixupCutmix
from protopformer_tpu_torch.data.preprocess import normalize_images
from protopformer_tpu_torch.ops.ppc import ppc_loss
from protopformer_tpu_torch.serving import no_tf32
from protopformer_tpu_torch.train.state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy in fp32 against integer labels or soft (B, cls)
    label distributions, with optional label smoothing."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    n = logits.shape[-1]
    if labels.dim() == logits.dim():
        target = labels.float()
    else:
        target = F.one_hot(labels.long(), n).float()
    if smoothing:
        target = target * (1.0 - smoothing) + smoothing / n
    return -(target * logp).sum(dim=-1).mean()


def _hard_labels(labels: torch.Tensor) -> torch.Tensor:
    return labels.argmax(dim=-1) if labels.dim() == 2 else labels.long()


def _to(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device, non_blocking=True)


def _precision(model: torch.nn.Module, device: torch.device):
    """TF32 off for an fp32 model on CUDA."""
    fp32 = getattr(model, "compute_dtype", torch.float32) == torch.float32
    return no_tf32() if fp32 and device.type == "cuda" \
        else contextlib.nullcontext()


def make_train_step(
    model,
    ppnet_cfg: Optional[PPNetConfig],
    optim_cfg: OptimConfig,
    smoothing: float = 0.0,
    mixup=None,
    normalize: bool = True,
    device="cuda",
) -> Callable:
    """Build the train step for ``model`` (the train state's model).

    The returned function is ``(state, batch {'image': (B, H, W, 3) in
    [0, 1], 'label': (B,) or (B, cls)}, generator, ppc_gate) -> (state,
    metrics)``; ``generator`` (a ``torch.Generator`` on ``device``) feeds
    the dropout and stochastic-depth draws. ``normalize=False`` is for
    callers that feed normalized images.

    ``mixup``: an optional ``data.mixup.MixupCutmix`` applied on the device
    inside the step, to the raw images before the normalize (the JAX
    step's order). Its scalar draws at step s come from the host generator
    ``np.random.default_rng((generator.initial_seed(), s, 7))``, as the
    JAX step folds 7 into its step key; the labels become soft (B, cls).
    """
    if mixup is not None and not isinstance(mixup, MixupCutmix):
        raise TypeError(f"mixup must be a MixupCutmix, got {type(mixup)}")
    dev = resolve_device(device)
    use_ppc = ppnet_cfg is not None and ppnet_cfg.use_ppc_loss
    ema_decay = optim_cfg.model_ema_decay if optim_cfg.model_ema else None

    def train_step(state: TrainState, batch, generator, ppc_gate):
        images = _to(batch["image"], dev).float()
        labels = _to(batch["label"], dev)
        if mixup is not None:
            mixed = mixup({"image": images, "label": labels},
                          np.random.default_rng(
                              (generator.initial_seed(), state.step, 7)))
            images, labels = mixed["image"], mixed["label"]
        if normalize:
            images = normalize_images(images)
        hard = _hard_labels(labels)
        net = state.model
        net.train()
        with _precision(net, dev):
            out = net(images, generator)
            ce = cross_entropy_loss(out.logits, labels, smoothing)
            metrics = {"ce_loss": ce}
            loss = ce
            if use_ppc:
                B, P = out.total_proto_act.shape[:2]
                cov, mean = ppc_loss(
                    out.total_proto_act.reshape(B, P, -1),
                    out.cls_attn_rollout, hard, ppnet_cfg.num_classes,
                    ppnet_cfg.num_prototypes_per_class,
                    int(round(out.cls_attn_rollout.shape[-1] ** 0.5)),
                    ppnet_cfg.ppc_cov_thresh, ppnet_cfg.ppc_mean_thresh,
                )
                cov = ppnet_cfg.ppc_cov_coe * cov
                mean = ppnet_cfg.ppc_mean_coe * mean
                loss = loss + ppc_gate * (cov + mean)
                metrics["ppc_cov_loss"] = cov
                metrics["ppc_mean_loss"] = mean
            metrics["loss"] = loss
            metrics["train_acc1"] = (
                out.logits.argmax(dim=-1) == hard).float().mean() * 100.0
            state.optimizer.zero_grad()
            loss.backward()
            state.apply_gradients(ema_decay)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(use_global: bool = True, normalize: bool = True,
                   device="cuda") -> Callable:
    """Build the eval step ``(model, batch) -> metrics``: per-batch sums
    (``n``, ``loss_sum``, ``correct1``, ``correct5`` and, with the global
    branch, ``global_correct1`` / ``local_correct1``) weighted by the
    batch's ``valid`` mask, so a padded last batch aggregates exactly.
    ``model`` is the module whose weights are evaluated (the train state's
    model or its EMA copy); it runs its eval forward, with the kernels."""
    dev = resolve_device(device)

    def eval_step(model, batch) -> Dict[str, torch.Tensor]:
        images = _to(batch["image"], dev).float()
        if normalize:
            images = normalize_images(images)
        labels = _to(batch["label"], dev).long()
        valid = (_to(batch["valid"], dev).float() if "valid" in batch
                 else torch.ones(labels.shape[0], device=dev))
        model.eval()
        with torch.inference_mode(), _precision(model, dev):
            out = model(images)
            logits = out.logits.float()
            loss_per = -torch.log_softmax(logits, dim=-1).gather(
                1, labels[:, None])[:, 0]

            def topk_correct(lg, k):
                idx = lg.topk(min(k, lg.shape[-1]), dim=-1).indices
                hit = (idx == labels[:, None]).any(dim=-1).float()
                return (hit * valid).sum()

            metrics = {
                "n": valid.sum(),
                "loss_sum": (loss_per * valid).sum(),
                "correct1": topk_correct(logits, 1),
                "correct5": topk_correct(logits, 5),
            }
            if use_global:
                metrics["global_correct1"] = topk_correct(
                    out.logits_global.float(), 1)
                metrics["local_correct1"] = topk_correct(
                    out.logits_local.float(), 1)
        return metrics

    return eval_step
