"""PPNet eval forward (port of part of ``protopformer_tpu/models/ppnet.py``).

Parameter names follow the reference PyTorch layout, so the state dict
that ``checkpoint/convert.py::state_dict_from_jax`` (or the JAX package's
``export_ppnet_state_dict``) emits loads with ``strict=True``:
``features.*``, ``add_on_layers.0.{weight,bias}`` (a 1x1 conv, applied
here as a dense over the token channels), ``prototype_vectors`` and
``prototype_vectors_global`` (P, C, 1, 1), the frozen ``ones`` and the
frozen class-identity heads ``last_layer`` / ``last_layer_global``.
Distances, similarities and the heads are fp32 in both compute dtypes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from protopformer_tpu_torch.core.config import (
    BackboneConfig,
    PPNetConfig,
    check_ported,
)
from protopformer_tpu_torch.models.registry import create_backbone
from protopformer_tpu_torch.ops.distances import (
    distance_to_similarity,
    l2_distances,
)
from protopformer_tpu_torch.ops.tokens import gather_tokens, topk_sorted_indices


class EvalOutput(NamedTuple):
    """Eval forward contract (the JAX package's field order)."""

    logits: torch.Tensor  # (B, num_classes)
    cls_token_attn: torch.Tensor  # (B, N) rollout CLS->patch scores
    distances: torch.Tensor  # (B, P, k, k) local prototype distances
    logits_global: torch.Tensor  # (B, num_classes)
    logits_local: torch.Tensor  # (B, num_classes)


def class_identity(num_prototypes: int, num_classes: int,
                   incorrect: float) -> torch.Tensor:
    """Frozen head weight (num_classes, P): +1 for the prototype's class,
    ``incorrect`` elsewhere."""
    per_class = num_prototypes // num_classes
    w = torch.full((num_classes, num_prototypes), incorrect)
    j = torch.arange(num_prototypes)
    w[j // per_class, j] = 1.0
    return w


class AddOnLayers(nn.Sequential):
    """'regular' add-on: 1x1 conv + sigmoid, applied to (B, K, C) tokens as
    a dense over channels in the compute dtype; the sigmoid is fp32."""

    def __init__(self, in_dim: int, proto_dim: int, dtype: torch.dtype):
        super().__init__(nn.Conv2d(in_dim, proto_dim, 1), nn.Sigmoid())
        self.dtype = dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        conv = self[0]
        h = F.linear(
            tokens.to(self.dtype), conv.weight[:, :, 0, 0].to(self.dtype),
            conv.bias.to(self.dtype),
        )
        return torch.sigmoid(h.float())


class PPNet(nn.Module):
    """Dual-branch prototype classifier over the pruning DeiT backbone."""

    def __init__(self, backbone_config: BackboneConfig, config: PPNetConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_ported(backbone_config, config)
        self.backbone_config = backbone_config
        self.config = config
        self.compute_dtype = compute_dtype
        P, C = config.num_prototypes, config.proto_dim
        self.features = create_backbone(backbone_config, compute_dtype)
        self.add_on_layers = AddOnLayers(
            backbone_config.embed_dim, C, compute_dtype
        )
        self.prototype_vectors = nn.Parameter(torch.rand(P, C, 1, 1))
        self.ones = nn.Parameter(torch.ones(P, C, 1, 1), requires_grad=False)
        if config.use_global:
            self.prototype_vectors_global = nn.Parameter(
                torch.rand(config.num_prototypes_global, C, 1, 1)
            )
        self.last_layer = nn.Linear(P, config.num_classes, bias=False)
        self.last_layer_global = nn.Linear(
            config.num_prototypes_global, config.num_classes, bias=False
        )
        for head in (self.last_layer, self.last_layer_global):
            head.weight.requires_grad_(False)
        self._set_class_identity()

    def _set_class_identity(self) -> None:
        cfg = self.config
        with torch.no_grad():
            self.last_layer.weight.copy_(class_identity(
                cfg.num_prototypes, cfg.num_classes,
                cfg.incorrect_class_connection,
            ))
            self.last_layer_global.weight.copy_(class_identity(
                cfg.num_prototypes_global, cfg.num_classes,
                cfg.incorrect_class_connection,
            ))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights in the reference's initial distributions:
        PyTorch's default Linear/Conv2d init (U(+-1/sqrt(fan_in))),
        LayerNorm ones/zeros, CLS token and position embedding N(0, 0.02^2),
        prototypes U(0, 1), heads at the class-identity pattern."""
        def uniform_(p, bound):
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                bound = m.weight[0].numel() ** -0.5
                uniform_(m.weight, bound)
                if m.bias is not None:
                    uniform_(m.bias, bound)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
        for p in (self.features.cls_token, self.features.pos_embed):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        protos = [self.prototype_vectors]
        if self.config.use_global:
            protos.append(self.prototype_vectors_global)
        for p in protos:
            p.copy_(torch.rand(p.shape, generator=generator))
        self._set_class_identity()

    # --- feature extraction ------------------------------------------------

    def _gather_at_prune(self) -> bool:
        """``prune_gather``: gather the kept set at the last prune point
        when it is the final reserve set ('auto': bf16 only)."""
        cfg = self.config
        rmap = dict(cfg.reserve_layer_nums)
        if not rmap or rmap[max(rmap)] != cfg.final_reserve_num:
            return False
        mode = self.backbone_config.prune_gather
        if mode != "auto":
            return mode == "on"
        return self.compute_dtype != torch.float32

    def conv_features(self, x: torch.Tensor):
        """(cls_tokens (B, 1, proto_dim), img_tokens (B, k, proto_dim),
        cls_token_attn (B, N) fp32)."""
        cfg = self.config
        cls_embed, x_embed = self.features.embed_all(x)
        gather_final = self._gather_at_prune()
        tokens, cls_token_attn = self.features.masked_forward(
            cls_embed, x_embed, cfg.reserve_layer_nums, gather_final
        )
        if gather_final:
            img_tokens = tokens[:, 1:]
        else:
            idx = topk_sorted_indices(cls_token_attn, cfg.final_reserve_num)
            img_tokens = gather_tokens(tokens[:, 1:], idx)
        return (self.add_on_layers(tokens[:, :1]),
                self.add_on_layers(img_tokens), cls_token_attn)

    # --- heads -------------------------------------------------------------

    def _pooled(self, tokens: torch.Tensor, prototypes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(activations (B, P) of the min distance, distances (B, K, P))."""
        cfg = self.config
        d = l2_distances(tokens, prototypes[:, :, 0, 0],
                         speed=self.compute_dtype != torch.float32)
        acts = distance_to_similarity(
            d.amin(dim=1), cfg.prototype_activation_function, cfg.epsilon
        )
        return acts, d

    def _branch_logits(self, cls_tokens, img_tokens):
        cfg = self.config
        local_acts, distances = self._pooled(img_tokens, self.prototype_vectors)
        logits_local = F.linear(local_acts, self.last_layer.weight)
        if cfg.use_global:
            global_acts, _ = self._pooled(
                cls_tokens, self.prototype_vectors_global
            )
            logits_global = F.linear(global_acts, self.last_layer_global.weight)
            logits = (cfg.global_coe * logits_global
                      + (1.0 - cfg.global_coe) * logits_local)
        else:
            logits_global = torch.zeros_like(logits_local)
            logits = logits_local
        return logits, logits_global, logits_local, distances

    @staticmethod
    def _to_grid(maps: torch.Tensor) -> torch.Tensor:
        """(B, K, P) token layout -> (B, P, k, k) grid layout."""
        B, K, P = maps.shape
        g = int(round(K ** 0.5))
        return maps.transpose(1, 2).reshape(B, P, g, g)

    def forward(self, x: torch.Tensor) -> EvalOutput:
        """Eval forward on (B, H, W, 3) NHWC images (normalized, or raw when
        the normalization is folded into the patch embedding)."""
        cls_tokens, img_tokens, cls_token_attn = self.conv_features(x)
        logits, logits_global, logits_local, distances = self._branch_logits(
            cls_tokens, img_tokens
        )
        return EvalOutput(
            logits=logits,
            cls_token_attn=cls_token_attn,
            distances=self._to_grid(distances),
            logits_global=logits_global,
            logits_local=logits_local,
        )


def construct_ppnet(
    backbone: BackboneConfig,
    ppnet: PPNetConfig,
    compute_dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
) -> PPNet:
    """Build a PPNet; with ``generator``, seeded random weights
    (``PPNet.reset_parameters``). Trained weights load separately with
    ``load_state_dict(strict=True)``."""
    model = PPNet(backbone, ppnet, compute_dtype)
    if generator is not None:
        model.reset_parameters(generator)
    return model
