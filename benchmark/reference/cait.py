"""Plain ProtoPFormer forward over a CaiT backbone: talking-heads blocks,
class attention and the rollout in the signed key space, with the PPNet
head, written from the published descriptions in plain PyTorch, float32,
with no kernel, cache or batching trick.

  * input: raw (B, H, W, 3) uint8 RGB; x / 255, then the ImageNet
    normalization, then the patch conv; the position embedding covers the
    patches only, and the CLS token carries none;
  * self-attention blocks (Touvron et al., "Going deeper with Image
    Transformers", arXiv:2103.17239): over the patches only, pre-LN, q
    scaled by head_dim^-1/2 before QK^T, the heads mixed by ``proj_l`` on
    the logits, a float32 softmax, the heads mixed by ``proj_w`` on the
    probabilities, so the maps are signed and their rows need not sum to
    1; each residual branch scaled by its LayerScale gamma; exact-erf GELU;
  * each block's map for the rollout is the head mean of the mixed
    probabilities (kept in bfloat16 where the configuration's speed mode
    stores it so). Its discard threshold is the k-th largest of its N^2
    signed values, k = N^2 - floor(ratio N^2); the entries below it are
    zeroed, the identity is added at ``identity_weight`` and the rows are
    normalized;
  * class-attention blocks: a separate CLS token updated against [CLS;
    patches], the query from the CLS row only, each branch scaled by its
    gamma, the MLP on the CLS row. The softmax is ProtoPFormer's masked
    form (Xue et al., arXiv:2208.10431): ``(exp(l - max) p + eps/N) /
    (sum exp(l - max) p + eps)``, eps = 1e-6, the max over the full row,
    the policy p all ones until the reserve block;
  * at the reserve block (a class-attention block index, here 1): the mean
    of the normalized head-mean class-attention rows of the blocks before
    it (discard at the same ratio over their 1 + N values, the identity at
    the CLS column, rows normalized), its CLS column dropped, rolled back
    through the self-attention maps in reverse; its top ``keep`` patches
    are the policy of the class attention from that block on;
  * head: the final LayerNorm over [CLS; patches], the kept patches in
    ascending index order, then as ``ppnet.py``: the 1x1 add-on conv and
    sigmoid, squared L2 distances to the local and global prototypes, the
    log similarity of the least distance, the frozen class-identity heads
    and the fused logits.

Departures from the papers, each the program's: the eps softmax runs in
every class-attention block, the policy all ones before the reserve block
(ProtoPFormer's code); the maps are kept in bfloat16 where the speed mode
stores them so; the product of the normalized maps is taken as a row
vector carried back through them, not materialized. It imports nothing of
the program; ``cast`` rounds every product's operands and the residual
stream (the low-precision control). The caller runs it with TF32 off
(``fp32_matmuls``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.ppnet import (  # noqa: F401
    SOFTMAX_EPS,
    Cast,
    discard_threshold,
    fp8_e4m3,
    fp32_matmuls,
    keep_fp32,
    linear,
    log_similarity,
    normalize_images,
    sq_distances,
)


def layer_norm(sd, key: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[key + ".weight"],
                        sd[key + ".bias"], eps)


def mix_heads(a: torch.Tensor, sd, key: str, cast: Cast) -> torch.Tensor:
    """Talking heads: (B, H, N, M) mixed over H by the (H, H) linear."""
    w, b = cast(sd[key + ".weight"]), sd[key + ".bias"]
    return torch.einsum("gh,bhnm->bgnm", w, cast(a)) + b[None, :, None, None]


def mlp(sd, prefix: str, x: torch.Tensor, cast: Cast) -> torch.Tensor:
    h = F.gelu(linear(x, sd[prefix + "mlp.fc1.weight"],
                      sd[prefix + "mlp.fc1.bias"], cast))
    return linear(h, sd[prefix + "mlp.fc2.weight"], sd[prefix + "mlp.fc2.bias"],
                  cast)


def talking_heads_block(sd, prefix: str, x: torch.Tensor, heads: int,
                        eps: float, cast: Cast):
    """One LayerScale self-attention block over the patches; returns (x,
    the head mean of the mixed probabilities (B, N, N))."""
    B, N, C = x.shape
    hd = C // heads
    h = layer_norm(sd, prefix + "norm1", x, eps)
    qkv = linear(h, sd[prefix + "attn.qkv.weight"],
                 sd.get(prefix + "attn.qkv.bias"), cast)
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(cast(q * hd ** -0.5), cast(k).transpose(-1, -2))
    logits = mix_heads(logits, sd, prefix + "attn.proj_l", cast)
    probs = mix_heads(torch.softmax(logits, dim=-1), sd,
                      prefix + "attn.proj_w", cast)
    out = torch.matmul(cast(probs), cast(v)).transpose(1, 2).reshape(B, N, C)
    out = linear(out, sd[prefix + "attn.proj.weight"],
                 sd[prefix + "attn.proj.bias"], cast)
    x = cast(x + sd[prefix + "gamma_1"] * out)
    h = mlp(sd, prefix, layer_norm(sd, prefix + "norm2", x, eps), cast)
    return cast(x + sd[prefix + "gamma_2"] * h), probs.mean(dim=1)


def masked_softmax(logits: torch.Tensor, policy: torch.Tensor
                   ) -> torch.Tensor:
    """ProtoPFormer's class-attention softmax over (B, H, 1, N) under a
    (B, N) keep-policy."""
    n = logits.shape[-1]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True)) \
        * policy[:, None, None, :]
    return (e + SOFTMAX_EPS / n) / (e.sum(dim=-1, keepdim=True) + SOFTMAX_EPS)


def class_attention_block(sd, prefix: str, x: torch.Tensor,
                          cls: torch.Tensor, policy: torch.Tensor,
                          heads: int, eps: float, cast: Cast):
    """One LayerScale class-attention block: the CLS token (B, 1, C)
    against [CLS; patches]; returns (cls, the head-mean map (B, 1, 1+N))."""
    u = torch.cat([cls, x], dim=1)
    B, M, C = u.shape
    hd = C // heads
    h = layer_norm(sd, prefix + "norm1", u, eps)

    def proj(name, rows):
        return linear(rows, sd[prefix + f"attn.{name}.weight"],
                      sd.get(prefix + f"attn.{name}.bias"), cast
                      ).reshape(B, -1, heads, hd).transpose(1, 2)

    q, k, v = proj("q", h[:, :1]), proj("k", h), proj("v", h)
    logits = torch.matmul(cast(q * hd ** -0.5), cast(k).transpose(-1, -2))
    probs = masked_softmax(logits, policy)
    out = torch.matmul(cast(probs), cast(v)).transpose(1, 2).reshape(B, 1, C)
    out = linear(out, sd[prefix + "attn.proj.weight"],
                 sd[prefix + "attn.proj.bias"], cast)
    cls = cast(cls + sd[prefix + "gamma_1"] * out)
    h = mlp(sd, prefix, layer_norm(sd, prefix + "norm2", cls, eps), cast)
    return cast(cls + sd[prefix + "gamma_2"] * h), probs.mean(dim=1)


def normalized(fmap: torch.Tensor, ratio: float, identity_weight: float
               ) -> torch.Tensor:
    """A (B, M, N) map, M <= N, with its entries below the discard
    threshold zeroed, the identity (its first M rows) added at
    ``identity_weight`` and each row divided by its sum."""
    M, N = fmap.shape[1:]
    t = discard_threshold(fmap, ratio)
    a = torch.where(fmap >= t[:, None, None], fmap, 0.0)
    a = a + identity_weight * torch.eye(N, device=fmap.device)[:M]
    return a / a.sum(dim=-1, keepdim=True)


def rollout_scores(seed: torch.Tensor, maps: List[torch.Tensor],
                   ratio: float, identity_weight: float, bf16_maps: bool
                   ) -> torch.Tensor:
    """``seed`` (B, 1, N) times the product of the normalized maps, the
    last map first; (B, N). With ``bf16_maps`` each map is kept in
    bfloat16 before its discard and normalization."""
    v = seed
    for fmap in reversed(maps):
        if bf16_maps:
            fmap = fmap.to(torch.bfloat16).float()
        v = torch.matmul(v, normalized(fmap, ratio, identity_weight))
    return v[:, 0]


def forward(sd: Dict[str, torch.Tensor], cfg: dict, images_u8: torch.Tensor,
            cast: Cast = keep_fp32) -> dict:
    """The CaiT PPNet eval forward over raw uint8 images.

    ``cfg`` holds a configuration file's backbone and head sizes and its
    mode's ``rollout_exact_discard``; one reserve block, a class-attention
    block index >= 1.

    Returns {"logits" (B, classes), "cls_token_attn" (B, N) rollout
    scores}.
    """
    C, heads = cfg["embed_dim"], cfg["num_heads"]
    eps, p = cfg["layer_norm_eps"], cfg["patch_size"]
    (reserve, keep), = zip(cfg["reserve_layers"], cfg["reserve_token_nums"])
    ratio = cfg["rollout_discard_ratio"]
    iw = cfg["rollout_identity_weight"]
    bf16_maps = not cfg["rollout_exact_discard"]
    f = "features."

    x = normalize_images(images_u8)
    x = F.conv2d(cast(x), cast(sd[f + "patch_embed.proj.weight"]),
                 sd[f + "patch_embed.proj.bias"], stride=p)
    x = cast(x.flatten(2).transpose(1, 2) + sd[f + "pos_embed"])
    B, N, _ = x.shape

    maps = []
    for i in range(cfg["depth"]):
        x, fmap = talking_heads_block(sd, f"{f}blocks.{i}.", x, heads, eps,
                                      cast)
        maps.append(fmap)

    cls = sd[f + "cls_token"].expand(B, -1, -1)
    policy = torch.ones((B, 1 + N), device=x.device)
    ca_rows = []
    scores = None
    for i in range(cfg["depth_token_only"]):
        if i == reserve:
            seed = torch.stack(ca_rows).mean(dim=0)[:, :, 1:]
            scores = rollout_scores(seed, maps, ratio, iw, bf16_maps)
            idx = torch.topk(scores, keep, dim=-1).indices.sort(-1).values
            policy = torch.zeros_like(policy)
            policy[:, 0] = 1.0
            policy.scatter_(1, idx + 1, 1.0)
        cls, ca_map = class_attention_block(
            sd, f"{f}blocks_token_only.{i}.", x, cls, policy, heads, eps, cast)
        ca_rows.append(normalized(ca_map, ratio, iw))

    feats = layer_norm(sd, f + "norm", torch.cat([cls, x], dim=1), eps)
    kept = torch.gather(feats[:, 1:], 1, idx[:, :, None].expand(-1, -1, C))
    w = sd["add_on_layers.0.weight"][:, :, 0, 0]

    def add_on(t):
        return torch.sigmoid(linear(t, w, sd["add_on_layers.0.bias"], cast))

    pe = cfg["epsilon"]
    d_local = sq_distances(add_on(kept), sd["prototype_vectors"][:, :, 0, 0],
                           cast)
    d_global = sq_distances(add_on(feats[:, :1]),
                            sd["prototype_vectors_global"][:, :, 0, 0], cast)
    local = log_similarity(d_local.amin(dim=1), pe) @ sd["last_layer.weight"].t()
    glob = (log_similarity(d_global.amin(dim=1), pe)
            @ sd["last_layer_global.weight"].t())
    coe = cfg["global_coe"]
    return {"logits": coe * glob + (1.0 - coe) * local,
            "cls_token_attn": scores}


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
