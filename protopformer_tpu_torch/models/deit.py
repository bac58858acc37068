"""DeiT backbone with attention-rollout token pruning, and the distilled
DeiT classifier (port of ``protopformer_tpu/models/deit.py``).

Every block gets the current policy (the static all-ones sentinel until
the first prune point). In ``masked_forward`` each pre-prune block keeps
the lazy rollout's raw head-fused map, its discard threshold and its
masked row sums; at a prune point the CLS row of the rollout ranks the
patches. ``masked_forward_thresh`` prunes on an external score instead and
rolls out eagerly: its pre-prune blocks emit normalized maps (K4).

The eval forward's structure follows the kernel gates, as the JAX
package's does (``deit.py:113-136``, ``:283-330``):
  * ``use_pallas`` "on"/"auto" under "mean" head fusion: the kernel
    structure (K1 on the bf16 pre-prune blocks, K3 on the others);
  * ``use_pallas="off"``, or "max"/"min" fusion: every block runs the
    headloop, which emits the fp32 head-mean map (stored bf16 in speed
    mode) or per-head probabilities fused here.
Each stored pre-prune map gets its threshold and row sums from K2
(``fused_map_stats``) when ``stats_kernel`` is "on"/"auto"; else from one
batched search at the prune point (``masked_map_stats_multi``) under
``rollout_stats_batched="on"``; else from ``masked_map_stats`` with the
probability bracket and ``rollout_discard_sample``.

In training mode (the JAX package's ``deterministic=False``) every block
runs the differentiable headloop and the detached maps take the same
statistics routes. Position dropout and dropout take ``drop_rate``; block
i's stochastic depth is ``drop_path_rate * i / (depth - 1)``.

The unpruned forwards (``embed_patches``, ``feature_maps``,
``forward_features``, ``forward``) and ``DistilledDeiT`` run every block
with no policy: a plain softmax and no kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from protopformer_tpu_torch.core.config import BackboneConfig
from protopformer_tpu_torch.core.device import resolve_device
from protopformer_tpu_torch.kernels.stats import fused_map_stats
from protopformer_tpu_torch.models.layers import (
    Block,
    Generator,
    PatchEmbed,
    dropout,
    layer_norm,
    seeded_init_,
)
from protopformer_tpu_torch.ops.rollout import (
    _fuse_heads,
    masked_map_stats,
    masked_map_stats_multi,
    normalize_attention_map,
    rollout_row_scores,
    rollout_row_scores_lazy,
)
from protopformer_tpu_torch.ops.tokens import (
    gather_tokens,
    reserve_policy,
    topk_sorted_indices,
)


def normalize_block_attention(attn: torch.Tensor, config: BackboneConfig
                              ) -> torch.Tensor:
    """One block's probabilities -> (B, N, N) fp32 normalized rollout map.
    Takes (B, H, N, N) per-head probabilities (fused by
    ``rollout_head_fusion``) or an already head-fused (B, N, N) map."""
    attn = attn.detach().float()
    fused = attn if attn.dim() == 3 else _fuse_heads(
        attn, config.rollout_head_fusion
    )
    return normalize_attention_map(
        fused,
        discard_ratio=config.rollout_discard_ratio,
        identity_weight=config.rollout_identity_weight,
        exact_discard=config.rollout_exact_discard,
    )


class DeiTBackbone(nn.Module):
    """DeiT/ViT encoder with attention taps and token pruning."""

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
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        rollout = (cfg.rollout_discard_ratio, cfg.rollout_identity_weight,
                   cfg.rollout_exact_discard)
        # stochastic depth rises linearly from 0 to drop_path_rate
        dpr = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
               for i in range(cfg.depth)]
        self.blocks = nn.ModuleList([
            Block(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                  cfg.layer_norm_eps, compute_dtype, rollout, cfg.drop_rate,
                  dpr[i], cfg.rollout_head_fusion, cfg.use_pallas != "off",
                  quant=cfg.quantize == "int8", ln_stats=cfg.ln_stats)
            for i in range(cfg.depth)
        ])
        self.norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def embed_patches(self, x: torch.Tensor, generator: Generator = None
                      ) -> torch.Tensor:
        """NHWC image -> (B, N, D) patch tokens with the position embedding
        of the patch slots (no CLS), in the compute dtype."""
        cd = self.compute_dtype
        tokens = self.patch_embed(x) + self.pos_embed[:, 1:].to(cd)
        if self.training:
            tokens = dropout(tokens, self.config.drop_rate, generator)
        return tokens

    def embed_all(self, x: torch.Tensor, generator: Generator = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC image -> (cls_embed (B, 1, D), patch_embed (B, N, D)) with
        the CLS token and position embedding, in the compute dtype."""
        cd = self.compute_dtype
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(cd).expand(x.shape[0], -1, -1)
        full = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(cd)
        if self.training:
            full = dropout(full, self.config.drop_rate, generator)
        return full[:, :1], full[:, 1:]

    def masked_forward(
        self,
        cls_embed: torch.Tensor,
        x_embed: torch.Tensor,
        reserve_layer_nums: Sequence[Tuple[int, int]],
        gather_final: bool = False,
        generator: Generator = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token-pruning forward.

        ``gather_final``: at the last prune point gather the kept tokens and
        run the remaining blocks on the (B, 1+k, D) sequence.
        ``generator``: the dropout and stochastic-depth draws in training
        mode.

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
        ratio, exact = cfg.rollout_discard_ratio, cfg.rollout_exact_discard
        stats_kernel = cfg.stats_kernel != "off"
        batched = cfg.rollout_stats_batched == "on"
        # pending: maps whose statistics wait for the next prune point,
        # where one batched search covers them all
        maps, stats, pending = [], [], []

        def flush():
            if pending:
                stats.extend(masked_map_stats_multi(
                    pending, ratio, exact, value_bound=1.0,
                    sample=cfg.rollout_discard_sample, stochastic_eps=1e-6,
                ))
                pending.clear()

        cls_token_attn = None
        for i, blk in enumerate(self.blocks):
            if i in reserve_map:
                flush()
                scores = rollout_row_scores_lazy(
                    maps, [t for t, _ in stats], [s for _, s in stats],
                    cls_row, cfg.rollout_identity_weight,
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
            x, aux = blk(x, policy, tap=i < last_prune, generator=generator)
            if i >= last_prune:
                continue
            if isinstance(aux, tuple):  # K1's lazy-rollout triple
                flush()
                maps.append(aux[0])
                stats.append(aux[1:])
                continue
            fmap = aux if aux.dim() == 3 else _fuse_heads(
                aux.float(), cfg.rollout_head_fusion)
            if not exact:
                fmap = fmap.to(torch.bfloat16)
            maps.append(fmap)
            if stats_kernel:
                stats.append(fused_map_stats(fmap, ratio, exact))
            elif batched:
                pending.append(fmap)
            else:
                # value_bound 1.0 and stochastic_eps: the bracket of a
                # head-fused eps-softmax map, as the JAX package passes
                stats.append(masked_map_stats(
                    fmap, ratio, exact, value_bound=1.0,
                    sample=cfg.rollout_discard_sample, stochastic_eps=1e-6,
                ))

        return layer_norm(x, self.norm, self.compute_dtype), cls_token_attn

    def masked_forward_thresh(
        self,
        cls_embed: torch.Tensor,
        x_embed: torch.Tensor,
        token_attn: torch.Tensor,
        reserve_layer_nums: Sequence[Tuple[int, int]],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Threshold-pruning forward: from each reserve layer on, keep the
        patches whose EXTERNAL score ``token_attn`` (B, N) is at least
        1/num_patches, and return the rollout over the blocks before the
        first prune point.

        Those blocks emit their normalized maps directly (K4 with exact
        discard; K3 and the prefix normalize otherwise; the headloop's map
        normalized in the kernel-off structure); K1's lazy triple is never
        asked for (``tap=False``).

        Returns:
          (x (B, 1+N, D) after the final LayerNorm, in the compute dtype;
           cls_token_attn (B, N) fp32 CLS row of the pre-prune rollout).
        """
        B, patch_num, _ = x_embed.shape
        seq_len = 1 + patch_num
        layer_ids = [layer for layer, _ in reserve_layer_nums]
        first_prune = min(layer_ids)

        x = torch.cat([cls_embed, x_embed], dim=1)
        policy = "ones"
        cls_row = torch.zeros((B, 1, seq_len), dtype=torch.float32,
                              device=x.device)
        cls_row[:, 0, 0] = 1.0
        norm_maps = []
        for i, blk in enumerate(self.blocks):
            if i in layer_ids:
                keep = (token_attn >= 1.0 / patch_num).float()
                policy = torch.cat(
                    [torch.ones((B, 1), dtype=torch.float32,
                                device=x.device), keep], dim=1
                )
            x, aux = blk(x, policy, tap=False, normalized=i < first_prune)
            if i < first_prune:
                norm_maps.append(aux)

        cls_token_attn = rollout_row_scores(norm_maps, cls_row)[:, 0, 1:]
        return layer_norm(x, self.norm, self.compute_dtype), cls_token_attn

    def _unmasked(self, x: torch.Tensor, generator: Generator = None
                  ) -> torch.Tensor:
        """(B, 1+N, D) after the final LayerNorm, every block with no
        policy."""
        tokens = torch.cat(self.embed_all(x, generator), dim=1)
        for blk in self.blocks:
            tokens, _ = blk(tokens, None, generator=generator)
        return layer_norm(tokens, self.norm, self.compute_dtype)

    def feature_maps(self, x: torch.Tensor, generator: Generator = None
                     ) -> torch.Tensor:
        """Unmasked forward, the patch features (B, N, D)."""
        return self._unmasked(x, generator)[:, 1:]

    def forward_features(self, x: torch.Tensor, generator: Generator = None
                         ) -> torch.Tensor:
        """Unmasked forward, the CLS feature (B, D) (timm's
        ``forward_features``, which ``BaseNet`` reads)."""
        return self._unmasked(x, generator)[:, 0]

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        return self.forward_features(x, generator)


class DistilledDeiT(nn.Module):
    """DeiT with a distillation token and two heads (the reference's
    ``DistilledVisionTransformer``): a standalone classifier, not a PPNet
    backbone. The position embedding has N+2 slots. Training mode returns
    (logits, logits_dist); eval mode their mean. Every block runs with no
    policy, so no kernel; the heads are fp32."""

    def __init__(self, config: BackboneConfig, num_classes: int = 1000,
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
        self.dist_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 2, D))
        rollout = (cfg.rollout_discard_ratio, cfg.rollout_identity_weight,
                   cfg.rollout_exact_discard)
        dpr = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
               for i in range(cfg.depth)]
        self.blocks = nn.ModuleList([
            Block(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                  cfg.layer_norm_eps, compute_dtype, rollout, cfg.drop_rate,
                  dpr[i])
            for i in range(cfg.depth)
        ])
        self.norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.head = nn.Linear(D, num_classes)
        self.head_dist = nn.Linear(D, num_classes)

    def forward(self, x: torch.Tensor, generator: Generator = None):
        """NHWC images -> eval: (B, num_classes) fp32 mean of the two
        heads; training: (logits, logits_dist)."""
        cd = self.compute_dtype
        tokens = self.patch_embed(x)
        prefix = torch.cat([self.cls_token, self.dist_token], dim=1).to(cd)
        full = torch.cat([prefix.expand(x.shape[0], -1, -1), tokens], dim=1)
        full = full + self.pos_embed.to(cd)
        for blk in self.blocks:
            full, _ = blk(full, None, generator=generator)
        full = layer_norm(full, self.norm, cd).float()
        logits = self.head(full[:, 0])
        logits_dist = self.head_dist(full[:, 1])
        if self.training:
            return logits, logits_dist
        return (logits + logits_dist) / 2.0


def construct_distilled_deit(
    config: BackboneConfig,
    num_classes: int = 1000,
    compute_dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> DistilledDeiT:
    """A ``DistilledDeiT`` in eval mode on ``device`` ("cuda" unless the
    caller asks for the CPU; without CUDA the default raises); with
    ``generator``, seeded random weights (``layers.seeded_init_``)."""
    dev = resolve_device(device)
    model = DistilledDeiT(config, num_classes, compute_dtype)
    if generator is not None:
        seeded_init_(model, model, config.arch, config.init_scale, generator)
    return model.to(dev).eval()
