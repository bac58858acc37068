"""Operations and bytes, counted from shapes alone, and the card's peaks.

A forward's count is the multiply-adds of its products, two operations
each: the patch projection, each block's qkv, attention (QK^T and PV),
output projection and MLP at the tokens it runs on (every token before the
prune block, the CLS token and the kept patches from it on), the rollout's
vector-matrix products over the pre-prune maps, the add-on projection, the
distances' cross terms and the two class-identity heads. Elementwise work
is not counted: the count is what the model needs whatever implements it.

K1's contract (the fused attention and rollout-statistics launch of a
pre-prune block in bf16): it reads qkv (B, N, 3C) bf16 once and writes the
attention output (B, N, C) bf16, the head-mean map (B, N, N) in bf16
(speed) or fp32 (exact), the discard threshold (B,) and the masked row
sums (B, N) fp32 once; it performs QK^T and PV, 4 B N^2 C operations.
"""

from __future__ import annotations

# H100 SXM data-sheet peaks (dense, no sparsity), at the full 700 W limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def block_flops(n: int, c: int, hidden: int) -> float:
    """One DeiT block at n tokens of width c."""
    return 2.0 * n * c * (4 * c + 2 * hidden) + 4.0 * n * n * c


def backbone_flops(cfg: dict, pruned: bool = True) -> float:
    """Patch projection and blocks per image; with ``pruned`` the blocks
    from the prune block on run on the CLS token and the kept patches."""
    c, p = cfg["embed_dim"], cfg["patch_size"]
    hidden = int(c * cfg["mlp_ratio"])
    patches = (cfg["img_size"] // p) ** 2
    total = 2.0 * patches * 3 * p * p * c
    (prune, keep), = zip(cfg["reserve_layers"], cfg["reserve_token_nums"])
    for i in range(cfg["depth"]):
        n = keep + 1 if pruned and i >= prune else patches + 1
        total += block_flops(n, c, hidden)
    return total


def forward_flops(cfg: dict) -> float:
    """The pruned PPNet forward, one image."""
    c, d = cfg["embed_dim"], cfg["proto_dim"]
    patches = (cfg["img_size"] // cfg["patch_size"]) ** 2
    (prune, keep), = zip(cfg["reserve_layers"], cfg["reserve_token_nums"])
    local, classes = cfg["num_prototypes"], cfg["num_classes"]
    glob = classes * cfg["global_proto_per_class"]
    rollout = prune * 2.0 * (patches + 1) ** 2
    head = (2.0 * (keep + 1) * c * d + 2.0 * keep * d * local
            + 2.0 * d * glob + 2.0 * (local + glob) * classes)
    return backbone_flops(cfg) + rollout + head


def train_flops(cfg: dict) -> float:
    """A train step, one image: the train forward (the eval forward's
    products) and a backward of twice its operations."""
    return 3.0 * forward_flops(cfg)


def k1_bytes(b: int, n: int, c: int, exact: bool = False) -> float:
    """K1's contract bytes for one launch."""
    map_bytes = 4 if exact else 2
    return (b * n * 3 * c * 2 + b * n * c * 2 + b * n * n * map_bytes
            + b * 4 + b * n * 4)


def k1_flops(b: int, n: int, c: int) -> float:
    return 4.0 * b * n * n * c


def k1_bound_s(b: int, n: int, c: int, exact: bool = False) -> float:
    """The least time one K1 launch could take: the larger of its bytes over
    the memory rate and its operations over the bf16 peak."""
    return max(k1_bytes(b, n, c, exact) / HBM_BYTES_PER_S,
               k1_flops(b, n, c) / BF16_FLOPS)
