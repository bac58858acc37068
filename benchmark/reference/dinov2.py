"""Plain ProtoPFormer forward over a DINOv2 backbone with register tokens:
LayerScale blocks with the gated FFN, the attention rollout over the CLS
token, the registers and the patches, token pruning and the PPNet head,
written from the published descriptions in plain PyTorch, float32, with
no kernel, cache or batching trick.

  * input: raw (B, H, W, 3) uint8 RGB; x / 255, then the ImageNet
    normalization, then the patch conv (patch 14);
  * tokens (Oquab et al., "DINOv2", arXiv:2304.07193; Darcet et al.,
    "Vision Transformers Need Registers", arXiv:2309.16588): [CLS;
    patches] plus the position embedding, which covers the CLS token and
    the patches; then the R register tokens, which carry none, between the
    CLS token and the patches: [CLS; registers; patches];
  * blocks: pre-LN; attention with qkv and proj biases, the softmax in
    ProtoPFormer's eps form ``(exp(l - max) + eps/N) / (sum exp(l - max) +
    eps)``, eps = 1e-6; the gated FFN ``w3(silu(x1) * x2)`` with ``x1, x2``
    the two halves of ``w12(x)`` (DINOv2's ``SwiGLUFFNFused``); each
    residual branch scaled by its LayerScale gamma (``ls1``, ``ls2``);
  * rollout (Abnar & Zuidema), as ``ppnet.py`` takes it: each pre-prune
    block's head-mean map over all 1 + R + N tokens (kept in bfloat16
    where the configuration's speed mode stores it so), its entries below
    the k-th largest of the whole map zeroed, the identity blended in and
    the rows normalized; the CLS row of the product, at the patches'
    columns only, ranks the patches (the registers are never ranked);
  * at the prune block the top ``keep`` patches (ascending index order)
    are gathered behind the CLS token and the registers, and the remaining
    blocks run on them; the final LayerNorm over every token;
  * head as ``ppnet.py``: the 1x1 add-on conv and sigmoid, squared L2
    distances of the kept patches to the local prototypes and of the CLS
    token to the global ones (the registers feed neither), the log
    similarity of the least distance, the frozen class-identity heads and
    the fused logits.

Departures from the DINOv2 papers, each the program's (ProtoPFormer's):
the eps softmax in place of DINOv2's plain one; the rollout and the
pruning, which DINOv2 has not; the maps kept in bfloat16 where the speed
mode stores them so; the product of the normalized maps taken as a row
vector carried back through them, not materialized. It imports nothing of
the program; ``cast`` rounds every product's operands and the residual
stream (the low-precision control). The caller runs it with TF32 off
(``fp32_matmuls``, which ``serve_logits`` enters).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.ppnet import (  # noqa: F401
    Cast,
    eps_softmax,
    fp8_e4m3,
    fp32_matmuls,
    keep_fp32,
    linear,
    log_similarity,
    normalize_images,
    rollout_cls_scores,
    sq_distances,
)


def layer_norm(sd, key: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[key + ".weight"],
                        sd[key + ".bias"], eps)


def swiglu(sd, prefix: str, x: torch.Tensor, cast: Cast) -> torch.Tensor:
    """DINOv2's gated FFN: ``w3(silu(x1) * x2)``, ``x1, x2 = w12(x)``."""
    x1, x2 = linear(x, sd[prefix + "mlp.w12.weight"],
                    sd[prefix + "mlp.w12.bias"], cast).chunk(2, dim=-1)
    return linear(F.silu(x1) * x2, sd[prefix + "mlp.w3.weight"],
                  sd[prefix + "mlp.w3.bias"], cast)


def block(sd, prefix: str, x: torch.Tensor, heads: int, eps: float,
          cast: Cast):
    """One pre-LN LayerScale block with the gated FFN; returns (x, the
    head-mean attention map (B, M, M))."""
    B, M, C = x.shape
    hd = C // heads
    h = layer_norm(sd, prefix + "norm1", x, eps)
    qkv = linear(h, sd[prefix + "attn.qkv.weight"],
                 sd[prefix + "attn.qkv.bias"], cast)
    q, k, v = qkv.reshape(B, M, 3, heads, hd).permute(2, 0, 3, 1, 4)
    probs = eps_softmax(torch.matmul(cast(q), cast(k).transpose(-1, -2))
                        * hd ** -0.5)
    out = torch.matmul(cast(probs), cast(v)).transpose(1, 2).reshape(B, M, C)
    out = linear(out, sd[prefix + "attn.proj.weight"],
                 sd[prefix + "attn.proj.bias"], cast)
    x = cast(x + sd[prefix + "ls1.gamma"] * out)
    h = swiglu(sd, prefix, layer_norm(sd, prefix + "norm2", x, eps), cast)
    return cast(x + sd[prefix + "ls2.gamma"] * h), probs.mean(dim=1)


def forward(sd: Dict[str, torch.Tensor], cfg: dict, images_u8: torch.Tensor,
            cast: Cast = keep_fp32) -> dict:
    """The DINOv2-register PPNet eval forward over raw uint8 images.

    ``cfg`` holds a configuration file's backbone and head sizes and its
    mode's ``rollout_exact_discard``; one prune block.

    Returns {"logits" (B, classes), "cls_token_attn" (B, N) rollout scores
    of the patches}.
    """
    C, depth, heads = cfg["embed_dim"], cfg["depth"], cfg["num_heads"]
    eps, p = cfg["layer_norm_eps"], cfg["patch_size"]
    prefix = 1 + cfg["num_register_tokens"]
    (prune, keep), = zip(cfg["reserve_layers"], cfg["reserve_token_nums"])
    ratio = cfg["rollout_discard_ratio"]
    iw = cfg["rollout_identity_weight"]
    bf16_maps = not cfg["rollout_exact_discard"]
    f = "features."

    x = normalize_images(images_u8)
    x = F.conv2d(cast(x), cast(sd[f + "patch_embed.proj.weight"]),
                 sd[f + "patch_embed.proj.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    B = x.shape[0]
    cls = sd[f + "cls_token"].expand(B, -1, -1)
    x = torch.cat([cls, x], dim=1) + sd[f + "pos_embed"]
    regs = sd[f + "register_tokens"].expand(B, -1, -1)
    x = cast(torch.cat([x[:, :1], regs, x[:, 1:]], dim=1))

    maps, scores = [], None
    for i in range(depth):
        if i == prune:
            scores = rollout_cls_scores(maps, ratio, iw, bf16_maps)[:, prefix:]
            idx = torch.topk(scores, keep, dim=-1).indices.sort(-1).values
            kept = torch.gather(x[:, prefix:], 1,
                                idx[:, :, None].expand(-1, -1, C))
            x = torch.cat([x[:, :prefix], kept], dim=1)
        x, fmap = block(sd, f"{f}blocks.{i}.", x, heads, eps, cast)
        if i < prune:
            maps.append(fmap)
    x = layer_norm(sd, f + "norm", x, eps)

    w = sd["add_on_layers.0.weight"][:, :, 0, 0]

    def add_on(t):
        return torch.sigmoid(linear(t, w, sd["add_on_layers.0.bias"], cast))

    pe = cfg["epsilon"]
    d_local = sq_distances(add_on(x[:, prefix:]),
                           sd["prototype_vectors"][:, :, 0, 0], cast)
    d_global = sq_distances(add_on(x[:, :1]),
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
