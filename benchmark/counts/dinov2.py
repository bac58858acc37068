"""Operations and bytes of the DINOv2-register PPNet forward, counted from
shapes alone (two operations a multiply-add; elementwise work not
counted), and the contract bound of its gated FFN.

A forward's count, one image at P patches of width C behind a prefix of
the CLS token and R registers (M = 1 + R + P tokens), SwiGLU hidden width
h: the patch projection; each block before the prune block at M tokens:
qkv and the output projection (8 M C^2), QK^T and PV (4 M^2 C) and the
gated FFN (``w12`` to 2h and ``w3`` back: 6 M C h); each block from the
prune block on at 1 + R + keep tokens; the rollout's vector-matrix
products through the pre-prune maps (2 M^2 each); the head as the PPNet
computes it (the add-on on the CLS token and the kept patches, the
distances' cross terms, the two class-identity heads).

The gated FFN's region (span ``dinov2.swiglu``, one a block): it reads x
(B, N, C) bf16 and the weights (``w12`` C x 2h, ``w3`` h x C and their
biases, bf16) once, and writes ``w12``'s output (B, N, 2h), the gate
``silu(x1) * x2`` (B, N, h) and ``w3``'s output (B, N, C), bf16, once;
it performs 6 B N C h operations. Its bound is the larger of those bytes
over the memory rate and the operations over the bf16 peak: a function
of shapes alone, whatever implements the region.
"""

from __future__ import annotations

from benchmark.counts import BF16_FLOPS, HBM_BYTES_PER_S


def swiglu_hidden(c: int, mlp_ratio: float) -> int:
    return (int(c * mlp_ratio * 2 / 3) + 7) // 8 * 8


def block_flops(n: int, c: int, hidden: int) -> float:
    """One DINOv2 block with the gated FFN at n tokens of width c."""
    return 8.0 * n * c * c + 4.0 * n * n * c + 6.0 * n * c * hidden


def forward_flops(cfg: dict) -> float:
    """The pruned DINOv2-register PPNet forward, one image."""
    c, p, d = cfg["embed_dim"], cfg["patch_size"], cfg["proto_dim"]
    hidden = swiglu_hidden(c, cfg["mlp_ratio"])
    patches = (cfg["img_size"] // p) ** 2
    prefix = 1 + cfg["num_register_tokens"]
    (prune, keep), = zip(cfg["reserve_layers"], cfg["reserve_token_nums"])
    local, classes = cfg["num_prototypes"], cfg["num_classes"]
    glob = classes * cfg["global_proto_per_class"]
    total = 2.0 * patches * 3 * p * p * c
    for i in range(cfg["depth"]):
        n = prefix + keep if i >= prune else prefix + patches
        total += block_flops(n, c, hidden)
    total += prune * 2.0 * (prefix + patches) ** 2
    total += (2.0 * (keep + 1) * c * d + 2.0 * keep * d * local
              + 2.0 * d * glob + 2.0 * (local + glob) * classes)
    return total


def swiglu_bytes(b: int, n: int, c: int, hidden: int) -> float:
    activations = b * n * (c + 2 * hidden + hidden + c) * 2
    weights = (c * 2 * hidden + 2 * hidden + hidden * c + c) * 2
    return activations + weights


def swiglu_flops(b: int, n: int, c: int, hidden: int) -> float:
    return 6.0 * b * n * c * hidden


def swiglu_bound_s(b: int, n: int, c: int, hidden: int) -> float:
    """The least time one block's gated FFN could take."""
    return max(swiglu_bytes(b, n, c, hidden) / HBM_BYTES_PER_S,
               swiglu_flops(b, n, c, hidden) / BF16_FLOPS)
