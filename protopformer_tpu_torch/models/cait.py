"""CaiT backbone with class-attention token pruning (port of
``protopformer_tpu/models/cait.py``).

``depth`` LayerScale self-attention blocks run over the patch tokens (no
CLS), then ``depth_token_only`` class-attention blocks update a separate
CLS token against those patch tokens. The self-attention stage keeps, per
block, the lazy rollout's raw head-mean map with its discard threshold and
masked row sums, in the signed key space: talking-heads maps are not
probabilities and can be negative throughout (ROADMAP F4). Under
``rollout_stats_batched="on"`` one search covers all of them
(``masked_map_stats_multi``, bit-identical); under "max"/"min" head fusion
the blocks return per-head maps, fused here. At a
class-attention block ``i`` in the reserve list, the mean of the
normalized class-attention rows so far (CLS column dropped) is rolled back
through the self-attention maps, and its top-k policy masks the
class-attention softmax from block ``i`` on. No block here runs a kernel
of ``kernels/``: the JAX package runs this path outside any Pallas kernel.
In training mode the maps are detached, position dropout and dropout take
``drop_rate``, and every self-attention block's stochastic depth is the
uniform ``drop_path_rate`` (the class-attention blocks have none).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from protopformer_tpu_torch.core.config import BackboneConfig
from protopformer_tpu_torch.models.layers import (
    Generator,
    LayerScaleBlock,
    LayerScaleBlockClassAttn,
    PatchEmbed,
    dropout,
    layer_norm,
)
from protopformer_tpu_torch.ops.rollout import (
    _fuse_heads,
    masked_map_stats,
    masked_map_stats_multi,
    normalize_attention_map,
    rollout_row_scores_lazy,
)
from protopformer_tpu_torch.ops.tokens import reserve_policy


class CaiTBackbone(nn.Module):
    """CaiT encoder with attention taps and class-attention token pruning."""

    def __init__(self, config: BackboneConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.compute_dtype = compute_dtype
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(
            cfg.patch_size, cfg.in_chans, D, dtype=compute_dtype,
            impl=cfg.patch_embed,
        )
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        # the position embedding covers the patches only
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches, D))
        self.blocks = nn.ModuleList([
            LayerScaleBlock(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                            cfg.init_scale, cfg.layer_norm_eps, compute_dtype,
                            cfg.drop_rate, cfg.drop_path_rate,
                            cfg.rollout_head_fusion)
            for _ in range(cfg.depth)
        ])
        self.blocks_token_only = nn.ModuleList([
            LayerScaleBlockClassAttn(
                D, cfg.num_heads, cfg.mlp_ratio_token_only, cfg.qkv_bias,
                cfg.init_scale, cfg.layer_norm_eps, compute_dtype)
            for _ in range(cfg.depth_token_only)
        ])
        self.norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def embed_all(self, x: torch.Tensor, generator: Generator = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC image -> (cls_embed (B, 1, D), patch_embed (B, N, D)) in the
        compute dtype; the CLS token carries no position embedding."""
        cd = self.compute_dtype
        tokens = self.patch_embed(x) + self.pos_embed.to(cd)
        if self.training:
            tokens = dropout(tokens, self.config.drop_rate, generator)
        cls = self.cls_token.to(cd).expand(x.shape[0], -1, -1)
        return cls, tokens

    def masked_forward(
        self,
        cls_embed: torch.Tensor,
        x_embed: torch.Tensor,
        reserve_layer_nums: Sequence[Tuple[int, int]],
        generator: Generator = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pruning forward. Reserve layer indices name class-attention
        blocks and must be >= 1 (block 0 has no class-attention map to
        average yet). ``generator``: the dropout and stochastic-depth draws
        in training mode.

        Returns:
          (x (B, 1+N, D) = [CLS; patches] after the final LayerNorm, in the
           compute dtype; cls_token_attn (B, N) fp32 CLS->patch scores).
        """
        cfg = self.config
        B, patch_num, _ = x_embed.shape
        seq_len = 1 + patch_num
        reserve_map = dict(reserve_layer_nums)
        if min(reserve_map) < 1:
            raise ValueError("CaiT reserve layer must be >= 1")
        sample = 1 if cfg.rollout_exact_discard else cfg.rollout_discard_sample

        x = x_embed
        sa_maps = []
        for blk in self.blocks:
            x, fmap = blk(x, generator)
            if fmap.dim() == 4:  # "max"/"min" fusion: per-head maps
                fmap = _fuse_heads(fmap.float(), cfg.rollout_head_fusion)
            if not cfg.rollout_exact_discard:
                fmap = fmap.to(torch.bfloat16)
            sa_maps.append(fmap)
        stats_args = (cfg.rollout_discard_ratio, cfg.rollout_exact_discard)
        if cfg.rollout_stats_batched == "on":
            sa_stats = masked_map_stats_multi(sa_maps, *stats_args,
                                              signed=True, sample=sample)
        else:
            sa_stats = [masked_map_stats(m, *stats_args, signed=True,
                                         sample=sample) for m in sa_maps]
        sa_ts = [t for t, _ in sa_stats]
        sa_ss = [s for _, s in sa_stats]

        cls_tokens = cls_embed
        policy = torch.ones((B, seq_len), dtype=torch.float32,
                            device=x.device)
        ca_norm_sum = torch.zeros((B, 1, seq_len), dtype=torch.float32,
                                  device=x.device)
        cls_token_attn = None
        for i, blk in enumerate(self.blocks_token_only):
            if i in reserve_map:
                cls_scores = rollout_row_scores_lazy(
                    sa_maps, sa_ts, sa_ss, (ca_norm_sum / i)[:, :, 1:],
                    cfg.rollout_identity_weight,
                )
                cls_token_attn = cls_scores[:, 0]
                policy, _ = reserve_policy(
                    cls_token_attn, reserve_map[i], seq_len
                )
            cls_tokens, attn = blk(x, cls_tokens, policy)
            ca_norm_sum = ca_norm_sum + normalize_attention_map(
                _fuse_heads(attn.detach().float(), cfg.rollout_head_fusion),
                discard_ratio=cfg.rollout_discard_ratio,
                identity_weight=cfg.rollout_identity_weight,
            )

        x = torch.cat([cls_tokens, x], dim=1)
        return layer_norm(x, self.norm, self.compute_dtype), cls_token_attn

    def _unmasked(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1+N, D) after the final LayerNorm, no pruning."""
        cls_tokens, tokens = self.embed_all(x)
        for blk in self.blocks:
            tokens, _ = blk(tokens)
        for blk in self.blocks_token_only:
            cls_tokens, _ = blk(tokens, cls_tokens)
        full = torch.cat([cls_tokens, tokens], dim=1)
        return layer_norm(full, self.norm, self.compute_dtype)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """Unmasked forward, the CLS feature (B, D)."""
        return self._unmasked(x)[:, 0]

    def feature_maps(self, x: torch.Tensor) -> torch.Tensor:
        """Unmasked forward, the patch features (B, N, D)."""
        return self._unmasked(x)[:, 1:]
