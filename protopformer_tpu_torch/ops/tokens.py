"""Top-k token selection and gather (port of ``protopformer_tpu/ops/tokens.py``).

The JAX package gathers by a one-hot matmul, which is an exact selection;
here ``torch.gather`` is the same exact selection. Tie caveat as in the
JAX package: torch and jax ``top_k`` break exact-value ties differently.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_sorted_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, sorted
    ascending: ``topk(...)[1].sort(dim=-1)[0]``."""
    idx = torch.topk(scores, k, dim=-1).indices
    return torch.sort(idx, dim=-1).values


def gather_tokens(tokens: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, N, C) tokens at per-batch (B, K) indices -> (B, K, C)."""
    idx = indices.long()[:, :, None].expand(-1, -1, tokens.shape[-1])
    return torch.gather(tokens, 1, idx)


def reserve_policy(
    cls_token_attn: torch.Tensor, reserve_num: int, seq_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep-policy from CLS-attention scores.

    Returns:
      (policy (B, seq_len) fp32 in {0,1} with the CLS slot 1,
       patch_indices (B, reserve_num) sorted, into the patch axis).
    """
    B = cls_token_attn.shape[0]
    idx = topk_sorted_indices(cls_token_attn, reserve_num)
    policy = torch.zeros(
        (B, seq_len), dtype=torch.float32, device=cls_token_attn.device
    )
    policy[:, 0] = 1.0
    policy.scatter_(1, idx + 1, 1.0)
    return policy, idx
