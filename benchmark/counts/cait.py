"""Operations and bytes of the CaiT PPNet forward, counted from shapes
alone (two operations a multiply-add; elementwise work not counted), and
the contract bounds of its two map-shaped regions.

A forward's count, one image at P patches of width C, H heads: the patch
projection; each self-attention block over the P patches: qkv, QK^T and
PV (4 P^2 C), the two talking-heads mixes (4 H^2 P^2), the output
projection and the MLP; each class-attention block: q on the CLS row, k
and v over the 1 + P tokens, its attention (QK^T and PV of one row) and
projection, and the MLP on the CLS row; the rollout's vector-matrix
products through the self-attention maps at the reserve block; the head
as the PPNet computes it (the add-on on the CLS token and the kept
patches, the distances' cross terms, the two class-identity heads).

The talking-heads region (span ``cait.talking_heads``, one a block): it
reads qkv (B, N, 3C) bf16 once and writes the attention output (B, N, C)
bf16 and the head-mean map (B, N, N) in its stored dtype once; it performs
4 B N^2 C + 4 B H^2 N^2 operations. The signed search (span
``cait.signed_stats``, one a map): it reads the map (B, N, N) once in its
stored dtype and writes the threshold t (B,) and the row sums s (B, N)
fp32 once. Each bound is the larger of its bytes over the memory rate and
its operations over the bf16 peak: a function of shapes alone, whatever
implements the region.
"""

from __future__ import annotations

from benchmark.counts import BF16_FLOPS, HBM_BYTES_PER_S

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def self_attention_flops(n: int, c: int, heads: int, hidden: int) -> float:
    """One talking-heads block at n tokens of width c."""
    return (2.0 * n * c * (4 * c + 2 * hidden) + 4.0 * n * n * c
            + 4.0 * heads * heads * n * n)


def class_attention_flops(n: int, c: int, hidden: int) -> float:
    """One class-attention block over the CLS token and n patches."""
    tokens = n + 1
    return (2.0 * c * c * 2 + 2.0 * tokens * c * c * 2 + 4.0 * tokens * c
            + 2.0 * c * hidden * 2)


def forward_flops(cfg: dict) -> float:
    """The CaiT PPNet forward, one image."""
    c, p, d = cfg["embed_dim"], cfg["patch_size"], cfg["proto_dim"]
    heads = cfg["num_heads"]
    patches = (cfg["img_size"] // p) ** 2
    (_, keep), = zip(cfg["reserve_layers"], cfg["reserve_token_nums"])
    local, classes = cfg["num_prototypes"], cfg["num_classes"]
    glob = classes * cfg["global_proto_per_class"]
    total = 2.0 * patches * 3 * p * p * c
    total += cfg["depth"] * self_attention_flops(
        patches, c, heads, int(c * cfg["mlp_ratio"]))
    total += cfg["depth_token_only"] * class_attention_flops(
        patches, c, int(c * cfg["mlp_ratio_token_only"]))
    total += cfg["depth"] * 2.0 * patches * patches
    total += (2.0 * (keep + 1) * c * d + 2.0 * keep * d * local
              + 2.0 * d * glob + 2.0 * (local + glob) * classes)
    return total


def talking_heads_bytes(b: int, n: int, c: int, map_dtype: str) -> float:
    return (b * n * 3 * c * 2 + b * n * c * 2
            + b * n * n * DTYPE_BYTES[map_dtype])


def talking_heads_flops(b: int, n: int, c: int, heads: int) -> float:
    return 4.0 * b * n * n * c + 4.0 * b * heads * heads * n * n


def talking_heads_bound_s(b: int, n: int, heads: int, head_dim: int,
                          map_dtype: str) -> float:
    """The least time one block's talking-heads region could take."""
    c = heads * head_dim
    return max(talking_heads_bytes(b, n, c, map_dtype) / HBM_BYTES_PER_S,
               talking_heads_flops(b, n, c, heads) / BF16_FLOPS)


def signed_stats_bytes(b: int, n: int, map_dtype: str) -> float:
    return b * n * n * DTYPE_BYTES[map_dtype] + b * 4 + b * n * 4


def signed_stats_bound_s(b: int, n: int, map_dtype: str) -> float:
    """The least time one map's signed search and row sums could take."""
    return signed_stats_bytes(b, n, map_dtype) / HBM_BYTES_PER_S
