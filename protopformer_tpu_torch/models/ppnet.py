"""PPNet eval and train forwards (port of part of
``protopformer_tpu/models/ppnet.py``).

Eval mode (the JAX package's ``train=False``) returns ``EvalOutput``;
training mode returns ``TrainOutput``, with the activation maps the PPC
loss (``get_ppc_loss``) reads and the detached rollout scores;
``push_forward`` returns ``PushOutput``. ``BaseNet`` is the ablation
baseline (the unpruned backbone and a linear head).
``construct_ppnet`` returns a model in eval mode, as the JAX model's call
defaults to ``train=False``; ``model.train()`` selects the train forward.

Parameter names follow the reference PyTorch layout, so the state dict
that ``checkpoint/convert.py::state_dict_from_jax`` (or the JAX package's
``export_ppnet_state_dict``) emits loads with ``strict=True``:
``features.*``, ``add_on_layers.{2j}.{weight,bias}`` (1x1 convs, applied
here as dense layers over the token channels), ``prototype_vectors`` and
``prototype_vectors_global`` (P, C, 1, 1), the frozen ``ones`` and the
frozen class-identity heads ``last_layer`` / ``last_layer_global``. The
frozen tensors (``ones`` and the heads) do not require gradients.
Distances, similarities and the heads are fp32 in both compute dtypes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from protopformer_tpu_torch.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu_torch.core.device import resolve_device
from protopformer_tpu_torch.models.layers import Generator, seeded_init_
from protopformer_tpu_torch.models.registry import create_backbone
from protopformer_tpu_torch.ops.distances import (
    distance_to_similarity,
    l2_distances,
)
from protopformer_tpu_torch.ops.ppc import ppc_loss
from protopformer_tpu_torch.ops.tokens import gather_tokens, topk_sorted_indices


class EvalOutput(NamedTuple):
    """Eval forward contract (the JAX package's field order)."""

    logits: torch.Tensor  # (B, num_classes)
    cls_token_attn: torch.Tensor  # (B, N) rollout CLS->patch scores
    distances: torch.Tensor  # (B, P, k, k) local prototype distances
    logits_global: torch.Tensor  # (B, num_classes)
    logits_local: torch.Tensor  # (B, num_classes)


class PushOutput(NamedTuple):
    """push_forward contract (the JAX package's field order)."""

    cls_token_attn: torch.Tensor  # (B, N) rollout CLS->patch scores
    proto_acts: torch.Tensor  # (B, P, k, k) local activation maps


class TrainOutput(NamedTuple):
    """Train forward contract (the JAX package's field order)."""

    logits: torch.Tensor  # (B, num_classes)
    attn_loss: torch.Tensor  # 0-d fp32 zero, kept for the contract
    total_proto_act: torch.Tensor  # (B, P, k, k) activation maps
    cls_attn_rollout: torch.Tensor  # (B, N) detached rollout scores
    original_fea_len: int  # N


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
    """The add-on projection into prototype space, the reference's stack of
    1x1 convs applied to (B, K, C) tokens as dense layers over channels in
    the compute dtype, conv j at Sequential index 2j:
      * "regular": conv + sigmoid;
      * "bottleneck": a halving chain, while the width exceeds
        ``proto_dim`` (at least once): conv, ReLU, conv, then ReLU, or on
        the last pair a sigmoid.
    The sigmoid is fp32; the ReLUs run in the compute dtype."""

    def __init__(self, in_dim: int, proto_dim: int, dtype: torch.dtype,
                 kind: str = "regular"):
        if kind == "regular":
            layers = [nn.Conv2d(in_dim, proto_dim, 1), nn.Sigmoid()]
        elif kind == "bottleneck":
            layers, current = [], in_dim
            while current > proto_dim or not layers:
                out = max(proto_dim, current // 2)
                layers += [nn.Conv2d(current, out, 1), nn.ReLU(),
                           nn.Conv2d(out, out, 1),
                           nn.ReLU() if out > proto_dim else nn.Sigmoid()]
                current //= 2
        else:
            raise ValueError(f"unknown add_on_layers_type: {kind}")
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        h = tokens
        for layer in self:
            if isinstance(layer, nn.Conv2d):
                h = F.linear(h.to(self.dtype),
                             layer.weight[:, :, 0, 0].to(self.dtype),
                             layer.bias.to(self.dtype))
            elif isinstance(layer, nn.Sigmoid):
                h = torch.sigmoid(h.float())
            else:
                h = torch.relu(h)
        return h


class PPNet(nn.Module):
    """Dual-branch prototype classifier over a pruning backbone (DeiT,
    CaiT or DINOv2). A distilled config raises ``ValueError``: the distilled DeiT is
    a standalone classifier, not a feature extractor."""

    def __init__(self, backbone_config: BackboneConfig, config: PPNetConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if backbone_config.distilled:
            raise ValueError(
                "PPNet requires an attention-tap backbone; distilled "
                "variants are standalone classifiers (DistilledDeiT)"
            )
        self.backbone_config = backbone_config
        self.config = config
        self.compute_dtype = compute_dtype
        P, C = config.num_prototypes, config.proto_dim
        self.features = create_backbone(backbone_config, compute_dtype)
        self.add_on_layers = AddOnLayers(
            backbone_config.embed_dim, C, compute_dtype,
            config.add_on_layers_type,
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
        """Seeded random weights: ``layers.seeded_init_`` over the whole
        model, then prototypes U(0, 1) and the heads at the class-identity
        pattern."""
        bk = self.backbone_config
        seeded_init_(self, self.features, bk.arch, bk.init_scale, generator)
        protos = [self.prototype_vectors]
        if self.config.use_global:
            protos.append(self.prototype_vectors_global)
        for p in protos:
            p.copy_(torch.rand(p.shape, generator=generator))
        self._set_class_identity()

    # --- feature extraction ------------------------------------------------

    def _gather_at_prune(self) -> bool:
        """``prune_gather``: gather the kept set at the last prune point
        when it is the final reserve set ('auto': bf16 only). Only the DeiT
        masked forward (DeiT's and DINOv2's) gathers."""
        cfg = self.config
        rmap = dict(cfg.reserve_layer_nums)
        if (self.backbone_config.arch not in ("deit", "dinov2") or not rmap
                or rmap[max(rmap)] != cfg.final_reserve_num):
            return False
        mode = self.backbone_config.prune_gather
        if mode != "auto":
            return mode == "on"
        return self.compute_dtype != torch.float32

    def conv_features(self, x: torch.Tensor, generator: Generator = None):
        """(cls_tokens (B, 1, proto_dim), img_tokens (B, k, proto_dim),
        cls_token_attn (B, N) fp32). The local tokens are the kept patches
        after the backbone's prefix (a DINOv2 backbone's registers feed no
        prototype); the global branch reads the CLS token."""
        cfg = self.config
        cls_embed, x_embed = self.features.embed_all(x, generator)
        gather_final = self._gather_at_prune()
        tokens, cls_token_attn = self.features.masked_forward(
            cls_embed, x_embed, cfg.reserve_layer_nums,
            **({"gather_final": True} if gather_final else {}),
            generator=generator,
        )
        prefix = self.features.num_prefix_tokens
        if gather_final:
            img_tokens = tokens[:, prefix:]
        else:
            idx = topk_sorted_indices(cls_token_attn, cfg.final_reserve_num)
            img_tokens = gather_tokens(tokens[:, prefix:], idx)
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

    def forward(self, x: torch.Tensor, generator: Generator = None):
        """Forward on (B, H, W, 3) NHWC images (normalized, or raw when the
        normalization is folded into the patch embedding): ``EvalOutput``
        in eval mode, ``TrainOutput`` in training mode, whose dropout and
        stochastic depth draw from ``generator``."""
        cls_tokens, img_tokens, cls_token_attn = self.conv_features(
            x, generator
        )
        logits, logits_global, logits_local, distances = self._branch_logits(
            cls_tokens, img_tokens
        )
        if self.training:
            cfg = self.config
            act_maps = distance_to_similarity(
                distances, cfg.prototype_activation_function, cfg.epsilon
            )
            return TrainOutput(
                logits=logits,
                attn_loss=torch.zeros((), dtype=torch.float32,
                                      device=logits.device),
                total_proto_act=self._to_grid(act_maps),
                cls_attn_rollout=cls_token_attn.detach(),
                original_fea_len=cls_token_attn.shape[-1],
            )
        return EvalOutput(
            logits=logits,
            cls_token_attn=cls_token_attn,
            distances=self._to_grid(distances),
            logits_global=logits_global,
            logits_local=logits_local,
        )

    def push_forward(self, x: torch.Tensor) -> PushOutput:
        """The offline-analysis forward (the interpretability tools'): the
        eval forward's ``conv_features`` and prototype activations, run in
        eval mode under ``inference_mode``, so it reaches the serving
        kernels. ``proto_acts`` is the local branch's (B, P, k, k)
        activation grid over the k*k reserved tokens in ascending token
        order."""
        training = self.training
        self.eval()
        try:
            with torch.inference_mode():
                cls_tokens, img_tokens, cls_token_attn = self.conv_features(x)
                *_, distances = self._branch_logits(cls_tokens, img_tokens)
                cfg = self.config
                acts = distance_to_similarity(
                    distances, cfg.prototype_activation_function, cfg.epsilon
                )
        finally:
            self.train(training)
        return PushOutput(cls_token_attn=cls_token_attn,
                          proto_acts=self._to_grid(acts))

    def get_ppc_loss(self, total_proto_act: torch.Tensor,
                     cls_attn_rollout: torch.Tensor, label: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ppc_cov_loss, ppc_mean_loss) of a train forward's outputs;
        ``total_proto_act`` in grid (B, P, k, k) or token (B, P, K)
        layout."""
        cfg = self.config
        B, P = total_proto_act.shape[:2]
        return ppc_loss(
            total_proto_act.reshape(B, P, -1), cls_attn_rollout, label,
            cfg.num_classes, cfg.num_prototypes_per_class,
            int(round(cls_attn_rollout.shape[-1] ** 0.5)),
            cfg.ppc_cov_thresh, cfg.ppc_mean_thresh,
        )


class BaseNet(nn.Module):
    """The ablation baseline: the unpruned backbone's CLS feature and one
    fp32 linear head (the reference's ``BaseNet``). ``forward`` returns
    (logits, None); ``push_forward`` the (B, C, g, g) grid of the patch
    features."""

    def __init__(self, backbone_config: BackboneConfig, num_classes: int = 200,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone_config = backbone_config
        self.compute_dtype = compute_dtype
        self.features = create_backbone(backbone_config, compute_dtype)
        self.last_layer = nn.Linear(backbone_config.embed_dim, num_classes)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> Tuple[torch.Tensor, None]:
        feat = self.features.forward_features(x, generator)
        return self.last_layer(feat.float()), None

    def push_forward(self, x: torch.Tensor) -> torch.Tensor:
        maps = self.features.feature_maps(x)
        B, K, C = maps.shape
        g = int(round(K ** 0.5))
        return maps.transpose(1, 2).reshape(B, C, g, g)


def construct_basenet(
    backbone: BackboneConfig,
    num_classes: int = 200,
    compute_dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> BaseNet:
    """A ``BaseNet`` in eval mode on ``device`` ("cuda" unless the caller
    asks for the CPU; without CUDA the default raises); with
    ``generator``, seeded random weights (``layers.seeded_init_``)."""
    dev = resolve_device(device)
    model = BaseNet(backbone, num_classes, compute_dtype)
    if generator is not None:
        seeded_init_(model, model.features, backbone.arch, backbone.init_scale,
                     generator)
    return model.to(dev).eval()


def construct_ppnet(
    backbone: BackboneConfig,
    ppnet: PPNetConfig,
    compute_dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
) -> PPNet:
    """Build a PPNet in eval mode; with ``generator``, seeded random weights
    (``PPNet.reset_parameters``). Trained weights load separately with
    ``load_state_dict(strict=True)``."""
    model = PPNet(backbone, ppnet, compute_dtype)
    if generator is not None:
        model.reset_parameters(generator)
    return model.eval()
