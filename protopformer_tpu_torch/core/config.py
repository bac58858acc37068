"""Typed configuration for the PyTorch/CUDA port.

A copy of the JAX package's ``BackboneConfig``, ``PPNetConfig``,
``OptimConfig``, ``DataConfig``, ``TrainConfig`` and ``ExperimentConfig``
with the same fields, defaults and validation, except that the kernel gates
(``use_pallas``, ``stats_kernel``) default to ``"auto"``: in the port
``"on"`` and ``"auto"`` both select the kernels, which run on CUDA tensors
and whose plain PyTorch versions run on CPU tensors. ``"off"`` selects the
JAX package's kernel-off structure (``models/deit.py``): a configuration
the caller asks for, never a fallback.

Every value is accepted. ``quantize="int8"`` runs the blocks' products
int8 (``ops/quant.py``), ``ln_stats`` "compute"/"mxu" their LayerNorms
with compute-dtype or product statistics in bf16, and
``patch_embed="matmul"`` the patch projection as an unfold and one
product. The four ``attn_impl`` values name XLA lowerings of one
attention; the port runs its own single implementation for each.
``use_pallas`` selects the structure of an eval forward only: a module in
training mode always runs the differentiable plain attention, as the JAX
package's kernel gate requires ``deterministic``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """ViT backbone hyperparameters (field-for-field the JAX package's)."""

    name: str = "deit_tiny_patch16_224"
    arch: str = "deit"  # "deit" | "cait"
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    distilled: bool = False
    depth_token_only: int = 2
    init_scale: float = 1e-5
    mlp_ratio_token_only: float = 4.0
    rollout_discard_ratio: float = 0.9
    rollout_identity_weight: float = 0.2
    rollout_head_fusion: str = "mean"
    rollout_exact_discard: bool = True
    # K1 and K2 ignore it, as the JAX kernels do; the plain statistics
    # (the kernel-off structure, CaiT's signed ones) honour it
    rollout_discard_sample: int = 1
    rollout_stats_batched: str = "off"
    use_pallas: str = "auto"
    attn_impl: str = "headloop"
    stats_kernel: str = "auto"
    quantize: str = "off"
    prune_gather: str = "auto"
    patch_embed: str = "conv"
    ln_stats: str = "fp32"

    def __post_init__(self):
        _check = {
            "attn_impl": (self.attn_impl,
                          ("headloop", "batched", "headdense", "einsum")),
            "use_pallas": (self.use_pallas, ("on", "off", "auto")),
            "stats_kernel": (self.stats_kernel, ("on", "off", "auto")),
            "rollout_stats_batched": (self.rollout_stats_batched,
                                      ("on", "off")),
            "quantize": (self.quantize, ("off", "int8")),
            "prune_gather": (self.prune_gather, ("on", "off", "auto")),
            "patch_embed": (self.patch_embed, ("conv", "matmul")),
            "ln_stats": (self.ln_stats, ("fp32", "compute", "mxu")),
            "rollout_head_fusion": (self.rollout_head_fusion,
                                    ("mean", "max", "min")),
        }
        for name, (value, allowed) in _check.items():
            if value not in allowed:
                raise ValueError(
                    f"BackboneConfig.{name}={value!r} not in {allowed}"
                )
        if self.rollout_discard_sample not in (1, 2, 4, 8):
            raise ValueError(
                "BackboneConfig.rollout_discard_sample="
                f"{self.rollout_discard_sample!r} not in (1, 2, 4, 8)"
            )
        if self.rollout_discard_sample != 1 and self.rollout_exact_discard:
            raise ValueError(
                "rollout_discard_sample > 1 is a speed-mode approximation;"
                " it requires rollout_exact_discard=False"
            )

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size


BACKBONE_PRESETS: Dict[str, BackboneConfig] = {
    "deit_tiny_patch16_224": BackboneConfig(
        name="deit_tiny_patch16_224", arch="deit",
        embed_dim=192, depth=12, num_heads=3,
    ),
    "deit_small_patch16_224": BackboneConfig(
        name="deit_small_patch16_224", arch="deit",
        embed_dim=384, depth=12, num_heads=6,
    ),
    "deit_base_patch16_224": BackboneConfig(
        name="deit_base_patch16_224", arch="deit",
        embed_dim=768, depth=12, num_heads=12,
    ),
    "cait_xxs24_224": BackboneConfig(
        name="cait_xxs24_224", arch="cait",
        embed_dim=192, depth=24, num_heads=4, init_scale=1e-5,
    ),
    "cait_s24_224": BackboneConfig(
        name="cait_s24_224", arch="cait",
        embed_dim=384, depth=24, num_heads=8, init_scale=1e-5,
    ),
    "deit_base_patch16_384": BackboneConfig(
        name="deit_base_patch16_384", arch="deit", img_size=384,
        embed_dim=768, depth=12, num_heads=12,
    ),
    "deit_tiny_distilled_patch16_224": BackboneConfig(
        name="deit_tiny_distilled_patch16_224", arch="deit",
        embed_dim=192, depth=12, num_heads=3, distilled=True,
    ),
    "deit_small_distilled_patch16_224": BackboneConfig(
        name="deit_small_distilled_patch16_224", arch="deit",
        embed_dim=384, depth=12, num_heads=6, distilled=True,
    ),
    "deit_base_distilled_patch16_224": BackboneConfig(
        name="deit_base_distilled_patch16_224", arch="deit",
        embed_dim=768, depth=12, num_heads=12, distilled=True,
    ),
    "deit_base_distilled_patch16_384": BackboneConfig(
        name="deit_base_distilled_patch16_384", arch="deit", img_size=384,
        embed_dim=768, depth=12, num_heads=12, distilled=True,
    ),
    "deit_tiny_patch2_32": BackboneConfig(
        name="deit_tiny_patch2_32", arch="deit",
        img_size=32, patch_size=2, embed_dim=192, depth=12, num_heads=3,
    ),
    "deit_tiny_patch2_28": BackboneConfig(
        name="deit_tiny_patch2_28", arch="deit",
        img_size=28, patch_size=2, embed_dim=192, depth=12, num_heads=3,
    ),
    "deit_micro_test": BackboneConfig(
        name="deit_micro_test", arch="deit",
        img_size=32, patch_size=8, embed_dim=24, depth=3, num_heads=2,
    ),
    "cait_micro_test": BackboneConfig(
        name="cait_micro_test", arch="cait",
        img_size=32, patch_size=8, embed_dim=24, depth=3, num_heads=2,
        depth_token_only=2,
    ),
}


def backbone_preset(name: str, **overrides: Any) -> BackboneConfig:
    cfg = BACKBONE_PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclass(frozen=True)
class PPNetConfig:
    """Prototype-network hyperparameters (field-for-field the JAX
    package's). ``prototype_shape`` keeps the reference's (P, C, 1, 1)."""

    prototype_shape: Tuple[int, int, int, int] = (2000, 192, 1, 1)
    num_classes: int = 200
    reserve_layers: Tuple[int, ...] = (11,)
    reserve_token_nums: Tuple[int, ...] = (81,)
    use_global: bool = True
    use_ppc_loss: bool = True
    ppc_cov_thresh: float = 1.0
    ppc_mean_thresh: float = 2.0
    global_coe: float = 0.5
    global_proto_per_class: int = 10
    prototype_activation_function: str = "log"
    add_on_layers_type: str = "regular"
    epsilon: float = 1e-4
    incorrect_class_connection: float = -0.5
    ppc_start_epoch: int = 20
    ppc_cov_coe: float = 0.1
    ppc_mean_coe: float = 0.5

    @property
    def num_prototypes(self) -> int:
        return self.prototype_shape[0]

    @property
    def proto_dim(self) -> int:
        return self.prototype_shape[1]

    @property
    def num_prototypes_global(self) -> int:
        return self.num_classes * self.global_proto_per_class

    @property
    def num_prototypes_per_class(self) -> int:
        if self.num_prototypes % self.num_classes:
            raise ValueError("num_prototypes must divide into num_classes")
        return self.num_prototypes // self.num_classes

    @property
    def reserve_layer_nums(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(zip(self.reserve_layers, self.reserve_token_nums))

    @property
    def final_reserve_num(self) -> int:
        return self.reserve_token_nums[-1]


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer and schedule knobs (field-for-field the JAX package's).

    Three trainable parameter groups, each with its own LR; the frozen
    class-identity heads are in no group."""

    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Tuple[float, float] = (0.9, 0.999)
    momentum: float = 0.9
    weight_decay: float = 0.05  # the prototype group
    group_weight_decay: float = 1e-3  # the features and add-on groups
    clip_grad: Optional[float] = None
    features_lr: float = 1e-4
    add_on_layers_lr: float = 3e-3
    prototype_vectors_lr: float = 3e-3
    sched: str = "cosine"
    epochs: int = 200
    warmup_epochs: int = 5
    warmup_lr: float = 1e-4
    min_lr: float = 1e-5
    decay_epochs: float = 10
    decay_rate: float = 0.1
    cooldown_epochs: int = 10
    model_ema: bool = True
    model_ema_decay: float = 0.99996
    # timm LR noise: epoch fractions; one value = noise from that epoch on,
    # two = a [start, end) window
    lr_noise: Optional[Tuple[float, ...]] = None
    lr_noise_pct: float = 0.67
    lr_noise_std: float = 1.0
    noise_seed: int = 42
    lr_cycle_limit: int = 1


@dataclass(frozen=True)
class DataConfig:
    """Dataset and augmentation knobs (field-for-field the JAX package's)."""

    data_set: str = "CUB2011U"
    data_path: str = "./datasets/cub200_cropped/"
    input_size: int = 224
    batch_size: int = 256
    color_jitter: float = 0.4
    aa: str = "rand-m9-mstd0.5-inc1"
    train_interpolation: str = "bicubic"
    reprob: float = 0.25
    remode: str = "pixel"
    recount: int = 1
    smoothing: float = 0.0
    enable_smoothing: bool = False
    mixup: float = 0.0
    cutmix: float = 1.0
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"
    enable_mixup: bool = False
    num_workers: int = 10


@dataclass(frozen=True)
class TrainConfig:
    """Run-level knobs (field-for-field the JAX package's). Parameters are
    fp32; ``compute_dtype`` is the dtype of the backbone's products
    ("bfloat16" or "float32")."""

    seed: int = 1028
    output_dir: str = "output/"
    resume: str = ""
    start_epoch: int = 0
    eval_only: bool = False
    save_ep_freq: int = 400
    dist_eval: bool = False
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class ExperimentConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    ppnet: PPNetConfig = field(default_factory=PPNetConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
