"""Plain ProtoPFormer train steps: the loss (cross-entropy plus the PPC
losses), its gradients by autograd through ``ppnet.forward`` and AdamW,
written out from its published update (Loshchilov & Hutter), over the
three parameter groups of the reference recipe (backbone, add-on layers,
prototype vectors), with the epoch-staircase cosine schedule of timm's
``CosineLRScheduler``. float32, TF32 off. It imports nothing of the
program.

PPC (ProtoPFormer's prototypical part concentration): the label's local
prototypes' activation maps over the kept tokens are put back on the patch
grid; the loss penalizes their activation-weighted spatial variance above
``ppc_cov_thresh`` and pairwise distances of their weighted means below
``ppc_mean_thresh``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import ppnet

FROZEN = ("ones", "last_layer.weight", "last_layer_global.weight")


def group_of(key: str) -> str:
    if key.startswith("add_on_layers."):
        return "add_on"
    if key.startswith("prototype_vectors"):
        return "prototypes"
    return "features"


def lr_at(optim: dict, group: str, step: int) -> float:
    """The group's LR at optimizer step ``step``: constant within an epoch,
    linear warm-up, then a cosine from the base LR to ``min_lr``."""
    base = optim["lr"][group]
    t = float(step // optim["steps_per_epoch"])
    if t < optim["warmup_epochs"]:
        return optim["warmup_lr"] + t * (base - optim["warmup_lr"]) \
            / optim["warmup_epochs"]
    return optim["min_lr"] + 0.5 * (base - optim["min_lr"]) * (
        1.0 + math.cos(math.pi * t / optim["epochs"]))


def ppc_losses(act_maps: torch.Tensor, scores: torch.Tensor,
               labels: torch.Tensor, cfg: dict):
    """(covariance loss, mean-separation loss) before their weights;
    ``act_maps`` (B, P, K) over the kept tokens, ``scores`` (B, N) the
    rollout scores that chose them."""
    B, P, K = act_maps.shape
    N = scores.shape[1]
    g = int(round(N ** 0.5))
    per_class = P // cfg["num_classes"]
    protos = labels[:, None] * per_class + torch.arange(per_class,
                                                        device=labels.device)
    act = torch.gather(act_maps, 1, protos[:, :, None].expand(-1, -1, K))
    kept = torch.topk(scores, K, dim=-1).indices.sort(-1).values
    grid = torch.zeros((B, per_class, N), device=act.device).scatter(
        2, kept[:, None, :].expand(-1, per_class, -1), act)
    r = torch.arange(g, dtype=torch.float32, device=act.device)
    pts = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(N, 2)
    w = grid / grid.sum(-1, keepdim=True) * N
    mean = w @ pts / N  # (B, per_class, 2)
    d = pts - mean[:, :, None, :]
    cov = torch.einsum("bpn,bpni,bpnj->bpij", w, d, d) / (N - 1)
    cov_loss = torch.relu((cov[..., 0, 0] + cov[..., 1, 1]) / 2.0
                          - cfg["ppc_cov_thresh"]).mean()
    diff = mean[:, :, None, :] - mean[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1) + 1e-12)
    off = 1.0 - torch.eye(per_class, device=act.device)
    mean_loss = torch.relu((cfg["ppc_mean_thresh"] - dist) * off).mean()
    return cov_loss, mean_loss


def loss_fn(params: Dict[str, torch.Tensor], cfg: dict, batch,
            generator: torch.Generator, cast) -> torch.Tensor:
    images, labels = batch
    out = ppnet.forward(params, cfg, images, cast, generator)
    ce = F.cross_entropy(out["logits"], labels)
    cov, mean = ppc_losses(out["act_maps"], out["cls_token_attn"], labels,
                           cfg)
    return ce + cfg["ppc_cov_coe"] * cov + cfg["ppc_mean_coe"] * mean


def train_steps(sd: Dict[str, torch.Tensor], cfg: dict, optim: dict,
                batches: Sequence, generator: torch.Generator,
                cast=ppnet.keep_fp32) -> dict:
    """Run ``len(batches)`` AdamW steps from ``sd`` (left unchanged), the
    first at optimizer step ``optim["start_step"]``; ``generator`` feeds
    the stochastic depth of every step in turn.

    Returns {"losses": [each step's loss], "grads": {leaf: the first
    step's gradient}, "params": {leaf: the parameters after the last
    step}} over the trainable leaves."""
    keys = [k for k in sd if k not in FROZEN]
    params = {k: v.detach().clone().float() for k, v in sd.items()}
    m = {k: torch.zeros_like(params[k]) for k in keys}
    v = {k: torch.zeros_like(params[k]) for k in keys}
    b1, b2 = optim["betas"]
    losses: List[float] = []
    first_grads = None
    with ppnet.fp32_matmuls():
        for i, batch in enumerate(batches):
            for k in keys:
                params[k].requires_grad_(True)
            loss = loss_fn(params, cfg, batch, generator, cast)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
            losses.append(float(loss.detach()))
            if first_grads is None:
                first_grads = dict(zip(keys, grads))
            t, step = i + 1, optim["start_step"] + i
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    group = group_of(k)
                    lr = lr_at(optim, group, step)
                    p = params[k].detach() * (
                        1.0 - lr * optim["weight_decay"][group])
                    m[k] = b1 * m[k] + (1.0 - b1) * g
                    v[k] = b2 * v[k] + (1.0 - b2) * g * g
                    denom = (v[k].sqrt() / math.sqrt(1.0 - b2 ** t)
                             + optim["eps"])
                    params[k] = p - lr / (1.0 - b1 ** t) * m[k] / denom
    return {"losses": losses, "grads": first_grads,
            "params": {k: params[k].detach() for k in keys}}
