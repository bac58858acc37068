"""Plain ProtoPFormer forward: a DeiT backbone with attention-rollout token
pruning and the PPNet head, written from the published description in
plain PyTorch, float32, with no kernel, cache or batching trick.

  * input: raw (B, H, W, 3) uint8 RGB; x / 255, then the ImageNet
    normalization, then the patch conv (the program folds both into its
    patch embedding; here they stay apart);
  * DeiT blocks (Touvron et al., arXiv:2012.12877): pre-LN, exact-erf GELU,
    the attention softmax in ProtoPFormer's eps form
    ``(exp(l - max) + eps/N) / (sum exp(l - max) + eps)``, eps = 1e-6;
  * rollout (Abnar & Zuidema): each pre-prune block's head-mean map (kept
    in bfloat16 where the configuration's speed mode stores it so), its
    entries below the k-th largest zeroed (the lowest ``discard_ratio``),
    the identity blended in at ``identity_weight`` and the rows
    normalized; the CLS row of the product ranks the patches;
  * at the prune block the top ``keep`` patches (ascending index order)
    are gathered with the CLS token and the remaining blocks run on them;
  * head: 1x1 add-on conv + sigmoid, squared L2 distances to the local
    (image tokens) and global (CLS token) prototypes, the log similarity of
    the least distance, the frozen class-identity heads, and the fused
    logits ``coe * global + (1 - coe) * local``.

It imports nothing of the program. Weights come as a state dict in the
reference PyTorch layout (``features.blocks.{i}.attn.qkv.weight``, ...).
``cast`` rounds every product's operands and the residual stream, the
tensors the program holds in its compute dtype (the low-precision
control); the identity keeps float32. The caller runs it with TF32 off
(``fp32_matmuls``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SOFTMAX_EPS = 1e-6

Cast = Callable[[torch.Tensor], torch.Tensor]


def keep_fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float
               ) -> torch.Tensor:
    """``x`` rounded to an fp8 type with one scale a tensor (its abs-max
    onto the type's largest value ``top``), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """The fp8 training recipe's operand rounding: e4m3 on the way forward,
    e5m2 for the gradient on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x.float(), torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad.float(), torch.float8_e5m2, 57344.0)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """A product's operand in fp8 (the low-precision control): e4m3 values
    with one scale a tensor, and e5m2 gradients."""
    return _Fp8.apply(x)


@contextlib.contextmanager
def fp32_matmuls():
    """True float32 products: TF32 off for matmuls and cuDNN, restored on
    exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = conv


def linear(x, w, b, cast: Cast):
    return F.linear(cast(x), cast(w), b)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8, or float in [0, 1] (a training batch) -> (B, 3,
    H, W) normalized float32."""
    x = images_u8.float()
    if images_u8.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def eps_softmax(logits: torch.Tensor) -> torch.Tensor:
    n = logits.shape[-1]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return (e + SOFTMAX_EPS / n) / (e.sum(dim=-1, keepdim=True) + SOFTMAX_EPS)


def drop_path(h: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth: each sample's branch kept with probability
    1 - rate (scaled by 1 / (1 - rate)). One (B, 1, 1) uniform draw from
    ``generator`` a call."""
    if generator is None or rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand((h.shape[0], 1, 1), generator=generator,
                      device=h.device) < keep
    return torch.where(mask, h / keep, 0.0)


def block(sd, prefix: str, x: torch.Tensor, heads: int, eps: float,
          cast: Cast, rate: float = 0.0,
          generator: Optional[torch.Generator] = None):
    """One pre-LN DeiT block; returns (x, the head-mean attention map)."""
    B, N, C = x.shape
    hd = C // heads
    h = F.layer_norm(x, (C,), sd[prefix + "norm1.weight"],
                     sd[prefix + "norm1.bias"], eps)
    qkv = linear(h, sd[prefix + "attn.qkv.weight"],
                 sd[prefix + "attn.qkv.bias"], cast)
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    probs = eps_softmax(torch.matmul(cast(q), cast(k).transpose(-1, -2))
                        * hd ** -0.5)
    out = torch.matmul(cast(probs), cast(v)).transpose(1, 2).reshape(B, N, C)
    out = linear(out, sd[prefix + "attn.proj.weight"],
                 sd[prefix + "attn.proj.bias"], cast)
    x = cast(x + drop_path(out, rate, generator))
    h = F.layer_norm(x, (C,), sd[prefix + "norm2.weight"],
                     sd[prefix + "norm2.bias"], eps)
    h = F.gelu(linear(h, sd[prefix + "mlp.fc1.weight"],
                      sd[prefix + "mlp.fc1.bias"], cast))
    h = linear(h, sd[prefix + "mlp.fc2.weight"], sd[prefix + "mlp.fc2.bias"],
               cast)
    return cast(x + drop_path(h, rate, generator)), probs.detach().mean(dim=1)


def discard_threshold(fmap: torch.Tensor, ratio: float) -> torch.Tensor:
    """(B,) the keep-th largest entry of each (N, M) map, keep = N*M -
    int(N*M*ratio)."""
    B = fmap.shape[0]
    flat = fmap.reshape(B, -1)
    total = flat.shape[1]
    keep = total - int(total * ratio)
    return torch.kthvalue(flat, total - keep + 1, dim=1).values


def rollout_cls_scores(maps: List[torch.Tensor], ratio: float,
                       identity_weight: float, bf16_maps: bool
                       ) -> torch.Tensor:
    """CLS row of ``A'_L ... A'_1`` over the normalized maps; (B, N). With
    ``bf16_maps`` (the configuration's speed mode) each map is kept in
    bfloat16 before its discard and normalization."""
    B, N, _ = maps[0].shape
    v = torch.zeros((B, 1, N), device=maps[0].device)
    v[:, 0, 0] = 1.0
    eye = torch.eye(N, device=maps[0].device)
    for fmap in reversed(maps):
        if bf16_maps:
            fmap = fmap.to(torch.bfloat16).float()
        t = discard_threshold(fmap, ratio)
        a = torch.where(fmap >= t[:, None, None], fmap, 0.0)
        a = (a + identity_weight * eye) / (1.0 + identity_weight)
        a = a / a.sum(dim=-1, keepdim=True)
        v = torch.matmul(v, a)
    return v[:, 0]


def log_similarity(d: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.log((d + 1.0) / (d + eps))


def sq_distances(x: torch.Tensor, protos: torch.Tensor, cast: Cast
                 ) -> torch.Tensor:
    """(B, K, D) features, (P, D) prototypes -> (B, K, P) squared L2."""
    cross = torch.matmul(cast(x), cast(protos).t())
    d = (x * x).sum(-1, keepdim=True) - 2.0 * cross + (protos * protos).sum(-1)
    return torch.relu(d)


def forward(sd: Dict[str, torch.Tensor], cfg: dict, images_u8: torch.Tensor,
            cast: Cast = keep_fp32, generator: Optional[torch.Generator] = None
            ) -> dict:
    """The PPNet forward over raw uint8 images.

    ``cfg`` holds a configuration file's backbone and head sizes and its
    mode's ``rollout_exact_discard``; one prune block. With ``generator`` the
    forward is the training one: stochastic depth draws from it, block i
    at ``drop_path_rate * i / (depth - 1)``, two draws a block (attention,
    then MLP branch) in block order.

    Returns {"logits" (B, classes), "cls_token_attn" (B, N-1) rollout
    scores, "act_maps" (B, P, K) local log similarities of every kept
    token}.
    """
    C, depth, heads = cfg["embed_dim"], cfg["depth"], cfg["num_heads"]
    eps, p = cfg["layer_norm_eps"], cfg["patch_size"]
    (prune, keep), = zip(cfg["reserve_layers"], cfg["reserve_token_nums"])
    ratio = cfg["rollout_discard_ratio"]
    iw = cfg["rollout_identity_weight"]
    bf16_maps = not cfg["rollout_exact_discard"]
    dpr = [cfg["drop_path_rate"] * i / max(depth - 1, 1)
           for i in range(depth)]

    x = normalize_images(images_u8)
    x = F.conv2d(cast(x), cast(sd["features.patch_embed.proj.weight"]),
                 sd["features.patch_embed.proj.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    cls = sd["features.cls_token"].expand(x.shape[0], -1, -1)
    x = cast(torch.cat([cls, x], dim=1) + sd["features.pos_embed"])

    maps, scores = [], None
    for i in range(depth):
        if i == prune:
            scores = rollout_cls_scores(maps, ratio, iw, bf16_maps)[:, 1:]
            idx = torch.topk(scores, keep, dim=-1).indices.sort(-1).values
            kept = torch.gather(x[:, 1:], 1,
                                idx[:, :, None].expand(-1, -1, C))
            x = torch.cat([x[:, :1], kept], dim=1)
        x, fmap = block(sd, f"features.blocks.{i}.", x, heads, eps, cast,
                        dpr[i], generator)
        if i < prune:
            maps.append(fmap)
    x = F.layer_norm(x, (C,), sd["features.norm.weight"],
                     sd["features.norm.bias"], eps)

    w = sd["add_on_layers.0.weight"][:, :, 0, 0]
    feats = torch.sigmoid(linear(x, w, sd["add_on_layers.0.bias"], cast))
    pe = cfg["epsilon"]
    d_local = sq_distances(feats[:, 1:], sd["prototype_vectors"][:, :, 0, 0],
                           cast)
    d_global = sq_distances(feats[:, :1],
                            sd["prototype_vectors_global"][:, :, 0, 0], cast)
    local = log_similarity(d_local.amin(dim=1), pe) @ sd["last_layer.weight"].t()
    glob = (log_similarity(d_global.amin(dim=1), pe)
            @ sd["last_layer_global.weight"].t())
    coe = cfg["global_coe"]
    return {"logits": coe * glob + (1.0 - coe) * local,
            "cls_token_attn": scores,
            "act_maps": log_similarity(d_local, pe).transpose(1, 2)}


@torch.no_grad()
def serve_logits(sd, cfg: dict, images_u8: torch.Tensor, block_rows: int,
                 cast: Cast = keep_fp32) -> dict:
    """``forward`` in blocks of ``block_rows`` images, under
    ``fp32_matmuls``: {"logits", "cls_token_attn"} as float32 on the
    images' device."""
    outs = {"logits": [], "cls_token_attn": []}
    with fp32_matmuls():
        for s in range(0, images_u8.shape[0], block_rows):
            res = forward(sd, cfg, images_u8[s:s + block_rows], cast)
            outs["logits"].append(res["logits"])
            outs["cls_token_attn"].append(res["cls_token_attn"])
    return {k: torch.cat(v) for k, v in outs.items()}
