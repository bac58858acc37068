"""Policy-masked softmax (token-pruning attention).

Port of ``protopformer_tpu/ops/masking.py``. Semantics kept exactly:

  * the row max is taken over the FULL row (not the masked row);
  * a dropped token still attends to itself (``policy + (1-policy)*I``)
    in the DeiT variant; the CaiT class-attention variant has no identity
    escape (its query rows are the CLS token only);
  * the normalization is ``(p + eps/N) / (sum(p) + eps)`` with eps=1e-6,
    and every block of the pruning forward uses it, the pre-prune blocks
    with an all-ones policy.
"""

from __future__ import annotations

import torch


def softmax_with_policy(
    logits: torch.Tensor, policy: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """DeiT self-attention masked softmax.

    Args:
      logits: (B, H, N, N) pre-softmax scores (any float dtype).
      policy: (B, N) or (B, N, 1) keep-mask in {0, 1}.

    Returns:
      (B, H, N, N) probabilities in ``logits.dtype``.
    """
    B, H, N, _ = logits.shape
    pol = policy.reshape(B, 1, 1, N).float()
    eye = torch.eye(N, dtype=torch.float32, device=logits.device)
    attn_policy = pol + (1.0 - pol) * eye
    max_att = logits.amax(dim=-1, keepdim=True)
    attn = torch.exp((logits - max_att).float()) * attn_policy
    attn = (attn + eps / N) / (attn.sum(dim=-1, keepdim=True) + eps)
    return attn.to(logits.dtype)


def eps_softmax(logits: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``softmax_with_policy`` specialized to an all-ones policy.

    fp32 logits: ``(exp(l - max) + eps/N) / (sum exp(l - max) + eps)``.
    bf16 logits (speed mode): bf16 exp, fp32 row sum, bf16 reciprocal and
    multiply — each step rounds where the JAX package's bf16 branch does.
    """
    N = logits.shape[-1]
    max_att = logits.amax(dim=-1, keepdim=True)
    if logits.dtype == torch.float32:
        e = torch.exp(logits - max_att)
        return (e + eps / N) / (e.sum(dim=-1, keepdim=True) + eps)
    e = torch.exp(logits - max_att)
    s = e.float().sum(dim=-1, keepdim=True) + eps
    inv = (1.0 / s).to(logits.dtype)
    return (e + torch.tensor(eps / N, dtype=logits.dtype)) * inv


def class_attn_softmax_with_policy(
    logits: torch.Tensor, policy: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """CaiT class-attention masked softmax: no identity escape, the eps
    terms added after the policy product, the sums in fp32.

    Args:
      logits: (B, H, M, N) with M query rows (1, the CLS token).
      policy: (B, N) or (B, N, 1) keep-mask in {0, 1}.

    Returns:
      (B, H, M, N) probabilities in ``logits.dtype``.
    """
    B, H, M, N = logits.shape
    pol = policy.reshape(B, 1, 1, N).float()
    max_att = logits.amax(dim=-1, keepdim=True)
    attn = torch.exp((logits - max_att).float()) * pol
    attn = (attn + eps / N) / (attn.sum(dim=-1, keepdim=True) + eps)
    return attn.to(logits.dtype)
