"""Mixup / CutMix with timm semantics (port of
``protopformer_tpu/data/mixup.py``).

The reference wires timm's Mixup but ships with it disabled
(``enable_mixup=False`` by default — ref: main.py:41,159-171,
tools/engine_proto.py:45-46). ``make_train_step(mixup=...)`` applies it
inside the step, on the batch's device, before the normalize (which is
affine, so the order is the reference's normalize-then-mix).

The four scalar draws of a batch (whether to mix, mixup or cutmix, the
Beta-distributed lambda and the cutmix box centre) come from the
``np.random.Generator`` the caller passes, on the host: torch's Beta
sampler takes no generator. The mixing itself runs on torch tensors on
the batch's device, in fp32, with the JAX class's arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MixDraws:
    """The scalar draws of one batch: ``apply`` (mix at all), ``use_cutmix``
    (cutmix, else mixup), ``lam`` (the Beta draw), and the cutmix box's
    centre row ``cy`` and column ``cx``."""

    apply: bool
    use_cutmix: bool
    lam: float
    cy: int
    cx: int


class MixupCutmix:
    """Batch-mode mixup/cutmix returning soft labels.

    mixup_alpha / cutmix_alpha / prob / switch_prob mirror the reference
    flags (main.py:159-171). Call with the batch and a host generator.
    """

    def __init__(
        self,
        mixup_alpha: float = 0.0,
        cutmix_alpha: float = 1.0,
        prob: float = 1.0,
        switch_prob: float = 0.5,
        label_smoothing: float = 0.0,
        num_classes: int = 200,
    ):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def draw(self, rng: np.random.Generator, h: int, w: int) -> MixDraws:
        """The batch's scalar draws for images of h x w pixels."""
        both = self.mixup_alpha > 0 and self.cutmix_alpha > 0
        use_cutmix = (bool(rng.uniform() < self.switch_prob) if both
                      else self.cutmix_alpha > 0)
        alpha = (self.cutmix_alpha or 1.0) if use_cutmix else \
            (self.mixup_alpha or 1.0)
        lam = float(np.float32(rng.beta(alpha, alpha)))
        apply = bool(rng.uniform() < self.prob)
        return MixDraws(apply, use_cutmix, lam, int(rng.integers(0, h)),
                        int(rng.integers(0, w)))

    def _one_hot(self, labels: torch.Tensor, lam: torch.Tensor
                 ) -> torch.Tensor:
        off = self.label_smoothing / self.num_classes
        on = 1.0 - self.label_smoothing + off
        y = F.one_hot(labels.long(), self.num_classes).float() * (on - off) + off
        return y * lam + y.flip(0) * (1.0 - lam)

    @staticmethod
    def _cutmix_box(draws: MixDraws, h: int, w: int, lam: float):
        """The box's corners and the lambda its area gives, rounded as the
        JAX class rounds them (fp32 ratio, truncated cut sizes)."""
        ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
        cut_h = int(np.float32(h) * ratio)
        cut_w = int(np.float32(w) * ratio)
        y0 = min(max(draws.cy - cut_h // 2, 0), h)
        y1 = min(max(draws.cy + cut_h // 2, 0), h)
        x0 = min(max(draws.cx - cut_w // 2, 0), w)
        x1 = min(max(draws.cx + cut_w // 2, 0), w)
        lam_adj = np.float32(1.0) - (np.float32((y1 - y0) * (x1 - x0))
                                     / np.float32(h * w))
        return (y0, y1, x0, x1), float(lam_adj)

    def apply(self, batch: Dict[str, torch.Tensor], draws: MixDraws
              ) -> Dict[str, torch.Tensor]:
        """Mix ``batch`` {'image': (B, H, W, C), 'label': (B,)} with the
        given draws: the images mixed or cut with the batch flipped, the
        labels soft (B, num_classes) fp32."""
        images, labels = batch["image"], batch["label"]
        _, H, W, _ = images.shape
        lam = draws.lam if draws.apply else 1.0
        if not draws.apply:
            out = images
            lam_final = 1.0
        elif draws.use_cutmix:
            (y0, y1, x0, x1), lam_final = self._cutmix_box(draws, H, W, lam)
            out = images.clone()
            out[:, y0:y1, x0:x1] = images.flip(0)[:, y0:y1, x0:x1]
        else:
            lam_t = torch.tensor(lam, dtype=torch.float32,
                                 device=images.device)
            out = images * lam_t + images.flip(0) * (1.0 - lam_t)
            lam_final = lam
        soft = self._one_hot(labels, torch.tensor(
            lam_final, dtype=torch.float32, device=labels.device))
        return {**batch, "image": out, "label": soft}

    def __call__(self, batch: Dict[str, torch.Tensor],
                 rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        _, H, W, _ = batch["image"].shape
        return self.apply(batch, self.draw(rng, H, W))
