"""Prototype distances and activations (port of
``protopformer_tpu/ops/distances.py``).

Squared L2 by the ``|x|^2 - 2 x.p + |p|^2`` expansion as one matrix
product over (B, K, C) tokens; ``log((d + 1) / (d + eps))`` similarity;
the per-prototype activation is the similarity of the minimum distance.
"""

from __future__ import annotations

from typing import Tuple

import torch


def l2_distances(
    tokens: torch.Tensor, prototypes: torch.Tensor, speed: bool = False
) -> torch.Tensor:
    """(B, K, C) tokens, (P, C) prototypes -> (B, K, P) fp32 distances,
    clamped at 0. ``speed``: the cross term is a bf16 product with fp32
    accumulation; the squared norms stay fp32."""
    x = tokens.float()
    p = prototypes.float()
    x2 = (x * x).sum(dim=-1, keepdim=True)
    p2 = (p * p).sum(dim=-1)
    if speed:
        # bf16 operands, fp32 products and sums: what a bf16 product with
        # fp32 accumulation computes (a bf16 matmul would round its output)
        xp = torch.matmul(x.bfloat16().float(), p.bfloat16().float().t())
    else:
        xp = torch.matmul(x, p.t())
    return torch.relu(x2 - 2.0 * xp + p2)


def log_similarity(distances: torch.Tensor, epsilon: float = 1e-4) -> torch.Tensor:
    d = distances.float()
    return torch.log((d + 1.0) / (d + epsilon))


def distance_to_similarity(
    distances: torch.Tensor,
    activation_function: str = "log",
    epsilon: float = 1e-4,
) -> torch.Tensor:
    if activation_function == "log":
        return log_similarity(distances, epsilon)
    if activation_function == "linear":
        return -distances
    raise ValueError(
        f"unknown prototype_activation_function: {activation_function}"
    )


def prototype_activations(
    tokens: torch.Tensor,
    prototypes: torch.Tensor,
    activation_function: str = "log",
    epsilon: float = 1e-4,
    speed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(activations (B, P), distances (B, K, P), act_maps (B, K, P)).

    Both activation functions decrease with distance, so the max-pooled
    activation is the similarity of the minimum distance (bit-identical).
    """
    d = l2_distances(tokens, prototypes, speed=speed)
    act_maps = distance_to_similarity(d, activation_function, epsilon)
    pooled = distance_to_similarity(
        d.amin(dim=1), activation_function, epsilon
    )
    return pooled, d, act_maps
