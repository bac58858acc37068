"""DeiT backbone with attention-rollout token pruning (port of
``protopformer_tpu/models/deit.py``: ``embed_all`` and ``masked_forward``).

Every block gets the current policy (the static all-ones sentinel until
the first prune point). Per pre-prune block the lazy rollout keeps the raw
head-fused map, its discard threshold and its masked row sums; at a prune
point the CLS row of the rollout ranks the patches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from protopformer_tpu_torch.core.config import BackboneConfig, check_ported
from protopformer_tpu_torch.kernels.stats import fused_map_stats
from protopformer_tpu_torch.models.layers import Block, PatchEmbed, layer_norm
from protopformer_tpu_torch.ops.rollout import rollout_row_scores_lazy
from protopformer_tpu_torch.ops.tokens import (
    gather_tokens,
    reserve_policy,
    topk_sorted_indices,
)


class DeiTBackbone(nn.Module):
    """DeiT/ViT encoder with attention taps and token pruning."""

    def __init__(self, config: BackboneConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_ported(config)
        cfg = config
        self.config = cfg
        self.compute_dtype = compute_dtype
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(
            cfg.patch_size, cfg.in_chans, D, dtype=compute_dtype
        )
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        rollout = (cfg.rollout_discard_ratio, cfg.rollout_exact_discard)
        self.blocks = nn.ModuleList([
            Block(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                  cfg.layer_norm_eps, compute_dtype, rollout)
            for _ in range(cfg.depth)
        ])
        self.norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def embed_all(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC image -> (cls_embed (B, 1, D), patch_embed (B, N, D)) with
        the CLS token and position embedding, in the compute dtype."""
        cd = self.compute_dtype
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(cd).expand(x.shape[0], -1, -1)
        full = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(cd)
        return full[:, :1], full[:, 1:]

    def masked_forward(
        self,
        cls_embed: torch.Tensor,
        x_embed: torch.Tensor,
        reserve_layer_nums: Sequence[Tuple[int, int]],
        gather_final: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token-pruning forward.

        ``gather_final``: at the last prune point gather the kept tokens and
        run the remaining blocks on the (B, 1+k, D) sequence.

        Returns:
          (x after the final LayerNorm, in the compute dtype — (B, 1+N, D),
           or (B, 1+k, D) under ``gather_final``;
           cls_token_attn (B, N) fp32 rollout scores at the last prune point).
        """
        cfg = self.config
        B, patch_num, _ = x_embed.shape
        seq_len = 1 + patch_num
        reserve_map = dict(reserve_layer_nums)
        last_prune = max(reserve_map)

        x = torch.cat([cls_embed, x_embed], dim=1)
        policy = "ones"
        cls_row = torch.zeros((B, 1, seq_len), dtype=torch.float32,
                              device=x.device)
        cls_row[:, 0, 0] = 1.0
        maps, thresholds, row_sums = [], [], []
        cls_token_attn = None
        for i, blk in enumerate(self.blocks):
            if i in reserve_map:
                scores = rollout_row_scores_lazy(
                    maps, thresholds, row_sums, cls_row,
                    cfg.rollout_identity_weight,
                )
                cls_token_attn = scores[:, 0, 1:]
                if gather_final and i == last_prune:
                    idx = topk_sorted_indices(cls_token_attn, reserve_map[i])
                    x = torch.cat([x[:, :1], gather_tokens(x[:, 1:], idx)],
                                  dim=1)
                    policy = "ones"
                else:
                    policy, _ = reserve_policy(
                        cls_token_attn, reserve_map[i], seq_len
                    )
            x, aux = blk(x, policy, tap=i < last_prune)
            if i >= last_prune:
                continue
            if isinstance(aux, tuple):
                fmap, t, s = aux  # K1's lazy-rollout triple
            else:
                fmap = aux
                if not cfg.rollout_exact_discard:
                    fmap = fmap.to(torch.bfloat16)
                t, s = fused_map_stats(
                    fmap, cfg.rollout_discard_ratio, cfg.rollout_exact_discard
                )
            maps.append(fmap)
            thresholds.append(t)
            row_sums.append(s)

        return layer_norm(x, self.norm, self.compute_dtype), cls_token_attn
