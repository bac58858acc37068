"""Prototypical Part Concentration (PPC) loss (port of
``protopformer_tpu/ops/ppc.py``).

The label's ``proto_per_class`` local-prototype activation maps go from the
k reserved tokens back onto the full token grid; the loss penalizes (a) a
large activation-weighted spatial covariance and (b) a small pairwise
distance between the activation-weighted spatial means. Everything is fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from protopformer_tpu_torch.ops.tokens import (
    scatter_tokens_to_grid,
    topk_sorted_indices,
)


def _coordinate_lattice(grid_size: int, device=None) -> torch.Tensor:
    """(N, 2) fp32 points [[x, y] for x in range(g) for y in range(g)]."""
    r = torch.arange(grid_size, dtype=torch.float32, device=device)
    x, y = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)


def weighted_spatial_stats(weights: torch.Tensor, grid_size: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation-weighted mean and covariance over the coordinate lattice:
    the weights are scaled to sum to N, the mean divides by N and the
    covariance by N - 1.

    Args:
      weights: (M, N) non-negative weights, N == grid_size**2.
    Returns:
      (mean (M, 2), cov (M, 2, 2)) fp32.
    """
    w = weights.float()
    N = w.shape[-1]
    pts = _coordinate_lattice(grid_size, w.device)
    w = w / w.sum(dim=-1, keepdim=True) * N
    mean = torch.einsum("mn,nd->md", w, pts) / N
    diffs = pts[None] - mean[:, None]
    cov = torch.einsum("mn,mni,mnj->mij", w, diffs, diffs) / (N - 1)
    return mean, cov


def ppc_loss(
    total_proto_act: torch.Tensor,
    cls_attn_rollout: torch.Tensor,
    label: torch.Tensor,
    num_classes: int,
    proto_per_class: int,
    grid_size: int,
    cov_thresh: float,
    mean_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPC covariance and mean-separation losses, before their weights.

    Args:
      total_proto_act: (B, P, K) activation maps of the K reserved tokens.
      cls_attn_rollout: (B, N) rollout scores, N = grid_size**2; its sorted
        top-K indices place the reserved tokens on the grid.
      label: (B,) integer class labels.

    Returns:
      (ppc_cov_loss, ppc_mean_loss) 0-d fp32 tensors. The mean loss
      averages over the full (B, ppc, ppc) matrix, zero diagonal included.
    """
    B, P, K = total_proto_act.shape
    N = grid_size * grid_size
    ar = torch.arange(proto_per_class, device=label.device)
    proto_idx = label.long()[:, None] * proto_per_class + ar
    act = torch.gather(total_proto_act.float(), 1,
                       proto_idx[:, :, None].expand(-1, -1, K))
    reserve_idx = topk_sorted_indices(cls_attn_rollout, K)
    grid_w = scatter_tokens_to_grid(act, reserve_idx, N)
    mean, cov = weighted_spatial_stats(
        grid_w.reshape(B * proto_per_class, N), grid_size
    )
    cov_loss = torch.relu((cov[:, 0, 0] + cov[:, 1, 1]) / 2.0
                          - cov_thresh).mean()
    mean = mean.reshape(B, proto_per_class, 2)
    diff = mean[:, :, None, :] - mean[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)
    offdiag = 1.0 - torch.eye(proto_per_class, dtype=torch.float32,
                              device=dist.device)
    mean_loss = torch.relu((mean_thresh - dist) * offdiag).mean()
    return cov_loss, mean_loss
