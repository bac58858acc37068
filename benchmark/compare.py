"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each a worst case over what was compared.

Serving (the worst sampled image):
  * ``logit_err``: the largest |program - reference| logit over the
    classes, over the spread (standard deviation) of the reference's
    logits over the classes. The CUB head's logits share a large common
    offset (every class weighs all 4,000 prototypes), so the spread, not
    the size, is the scale a classifier's answer lives on. The logits
    follow from every layer: the blocks, the rollout and its top-k
    selection, the blocks on the kept tokens, the distances and the heads;
  * ``attn_err``, where the mix asks for the explanation: the largest
    |program - reference| rollout score over the reference's largest
    score of that image.

Training (the first steps, taken by the worst leaf):
  * ``grad_gap``: the gap between the norms of a leaf's first gradient,
    over the larger of the reference's norm of that leaf and of the median
    leaf;
  * ``change_gap``: the same of the leaf's change over the steps, taken
    over its entries whose reference gradient is at least a thousandth of
    the median leaf's root-mean-square gradient: the others (a key's bias
    under softmax, a third of each qkv bias) have a gradient of nought to
    rounding and move under AdamW by round-off alone.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def serve_numbers(logits: np.ndarray, ref_logits: torch.Tensor,
                  attn: np.ndarray = None, ref_attn: torch.Tensor = None
                  ) -> Dict[str, float]:
    """``logit_err``, and ``attn_err`` where ``attn`` (the program's
    rollout scores) is given."""
    ref = ref_logits.double().cpu().numpy()
    got = np.asarray(logits, np.float64)
    out = {"logit_err": float((np.abs(got - ref).max(axis=1)
                               / ref.std(axis=1)).max())}
    if attn is not None:
        ra = ref_attn.double().cpu().numpy()
        out["attn_err"] = float((np.abs(np.asarray(attn, np.float64) - ra)
                                 .max(axis=1) / ra.max(axis=1)).max())
    return out


def serve_readings(logits: np.ndarray, ref_logits: torch.Tensor
                   ) -> Dict[str, float]:
    """Recorded beside the compared numbers and not compared (no
    lower-precision control reads three times what sound runs do on it):
    ``top1_gap``, how far below the reference's best class the reference
    puts the program's top class, in the spread's units."""
    ref = ref_logits.double().cpu().numpy()
    got = np.asarray(logits, np.float64)
    return {"top1_gap": float(((ref.max(axis=1)
                                - ref[np.arange(len(ref)), got.argmax(axis=1)])
                               / ref.std(axis=1)).max())}


def leaf_gap(got: Dict[str, float], ref: Dict[str, float]) -> float:
    """max over the leaves of |got - ref| / max(ref, the median leaf's
    ref)."""
    median = float(np.median(list(ref.values())))
    return max(abs(got[k] - ref[k]) / max(ref[k], median) for k in ref)


def train_numbers(grads: Dict[str, torch.Tensor],
                  params: Dict[str, torch.Tensor], ref: dict,
                  sd0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The program's first gradients and parameters after the checked
    steps against ``ref`` (``reference.train.train_steps``'s
    result from ``sd0``). The change is taken over the entries whose
    reference gradient is at least a thousandth of the median leaf's
    root-mean-square gradient; a leaf with no such entry is left out."""
    ref_grad = {k: float(g.norm()) for k, g in ref["grads"].items()}
    rms = np.median([float(g.pow(2).mean().sqrt())
                     for g in ref["grads"].values()])
    got_change, ref_change = {}, {}
    for k, g in ref["grads"].items():
        moving = g.abs() >= 1e-3 * rms
        if moving.any():
            got_change[k] = float(((params[k] - sd0[k]) * moving).norm())
            ref_change[k] = float(((ref["params"][k] - sd0[k]) * moving)
                                  .norm())
    return {
        "grad_gap": leaf_gap({k: float(grads[k].norm()) for k in ref_grad},
                             ref_grad),
        "change_gap": leaf_gap(got_change, ref_change),
    }


def train_readings(losses: Sequence[float], ref: dict) -> Dict[str, float]:
    """Recorded beside the compared numbers and not compared (neither the
    control nor a fault reads far enough above sound runs on it):
    ``loss_gap``, |program - reference| loss over the reference's, the
    worst step. With seeded weights the CUB head's 200 logits lie within
    about a hundredth of each other, so the cross-entropy sits near log 200
    whatever the precision."""
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref["losses"]))}
