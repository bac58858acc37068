#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``protopformer_tpu_torch``) on one GPU.

Run from anywhere, with the package beside this script, on a machine with a
CUDA card (an H100 is the target):

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernels from protopformer_tpu_torch/csrc (one nvcc per
     source, all started together), print each kernel's ptxas report, and
     from cuobjdump's SASS check that K1's and K3's bf16 kernels use the
     tensor cores (HMMA) and K3's fp32 kernel does not;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes (B=160; N=197, and N=82 after the prune-point gather),
     then timed with CUDA events beside its plain version and its bound;
     K1 (a cluster of CTAs per sample): t bit-equal to masked_map_stats on
     its own map, s within 1e-6; against the plain version the map within
     one bf16 ulp of its largest entry, out within 2 bf16 ulps of max|out|,
     at most 1e-4 of the map's entries and 2 of the 160 t values
     differing;
     K2 (t bit-equal, s within 1e-6) and K4/K5's normalize launch split
     one sample's map over a cluster of CTAs: each prints its cluster size
     and how many clusters the card holds at once;
     K4 and K5 (the normalized-map cores) are held against the plain
     normalize of K3's raw map and against their plain versions, K4 also
     and K5 only at the kernel bench's shapes and inputs (B=256); the
     device time of each of their two launches (attention, normalize)
     comes from a torch.profiler trace;
  4. serving: one ServingEngine per mode (bf16 speed, bf16 exact, fp32
     parity) over seeded random DeiT-Tiny/16@224 weights with 2000 local
     and 2000 global prototypes answers requests of 1, 160 and 333 images;
     every kernel launch counter is set to 0 just before a mode's requests
     and read just after, and must show the launches that mode's forward
     makes; then throughput_probe at B=160 and a torch.profiler breakdown
     of one chunk's forward (device-busy time, idle share, top kernels);
  4b. the threshold-pruning forward (DeiTBackbone.masked_forward_thresh,
     eager rollout) at full depth and B=160 on the same weights: bf16
     exact and fp32 must each launch K4 11 times and K3 once, nothing
     else; on 2 images fp32 must match the CPU (cls_token_attn within
     1e-5, x within 1e-4); against the CPU's bf16 and fp32 forwards, bf16
     exact must keep x within rtol 2e-2 plus 2e-2 * max|ref| and
     cls_token_attn within phase 5's selection contract;
  4c. the kernel bench (cli.bench_kernels.run) once; K5 must launch;
  5. the card against the CPU: fp32 parity on 2 images (logits within
     1e-4, the same top-81 tokens), and bf16 speed and bf16 exact against
     the CPU's fp32 forward (at least 74 of the top-81 tokens kept, none
     of fp32 rank below 64 dropped; logits within rtol 2e-2 plus
     2e-2 * max|logits|);
  6. one {"kernels": [...]} line, the nvidia-smi line again, and as the last
     line {"ok": true, "device": {"platform": "gpu", ...}}.

Without a CUDA device, or without the package beside it, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores

B, N, C, H = 160, 197, 192, 3  # DeiT-Tiny/16@224 at the serving batch
NP = 256  # K5's padded token count (the JAX kernel bench's)
N_GATHERED = 82  # CLS + the 81 kept tokens after the prune-point gather
DISCARD = 0.9
REQUESTS = (1, 160, 333)
PROBE_IMAGES = 160 * 8


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, *work):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type; ``work`` holds
    (operations, peak rate) pairs, one per type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(ops / peak for ops, peak in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulp(x: torch.Tensor) -> float:
    """The bf16 ulp (2^-7 of the power of two below) at max|x|."""
    return math.ldexp(1.0, math.frexp(float(x.float().abs().max()))[1] - 8)


def k1_contract(out, fmap, t, s, p_out, p_map, p_t, own_t, own_s) -> dict:
    """K1 against the plain version, as ``check_kernels`` describes; returns
    the readings, the limits and whether each holds."""
    B, N = fmap.shape[:2]
    map_diff = (fmap != p_map).flatten(1)
    t_diff = t != p_t.to(t.dtype)
    got = {"s": max_err(s, own_s), "map": max_err(fmap, p_map),
           "out": max_err(out, p_out),
           "map_entries_differ": int(map_diff.sum()),
           "t_differ": int(t_diff.sum())}
    limit = {"s": 1e-6, "map": bf16_ulp(p_map), "out": 2 * bf16_ulp(p_out),
             "map_entries_differ": max(int(1e-4 * fmap.numel()), N),
             "t_differ": max(1, B // 80)}
    return {"got": got, "limit": limit, "of": {"map": fmap.numel(), "t": B},
            "t_equal_own": bool(torch.equal(t, own_t)),
            "t_only_where_map_differs": bool(
                (map_diff.any(dim=1) | ~t_diff).all()),
            "holds": all(got[k] <= limit[k] for k in got)}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --- phase 2: what the kernels were compiled to ---------------------------------

# kernel family -> (test of a SASS function name, whether it must use HMMA)
SASS_FAMILIES = {
    "K1 block_stats_kernel (bf16)": (lambda n: "block_stats_kernel" in n, True),
    "K3 mean_kernel (bf16)": (lambda n: "bf16k" in n and "mean_kernel" in n,
                              True),
    "K3 mean_kernel (fp32)": (lambda n: "f32k" in n and "mean_kernel" in n,
                              False),
}


def check_sass() -> dict:
    """K1's and K3's bf16 kernels run on tensor cores (HMMA in every
    instantiation) and K3's fp32 kernel on CUDA cores only (no HMMA, so no
    TF32): per SASS function of the built library (``cuobjdump -sass``),
    whether it holds an HMMA instruction."""
    from protopformer_tpu_torch.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.BUILD_DIR / _build.LIB_NAME)],
        check=True, capture_output=True, text=True, timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = False
        elif name is not None and "HMMA" in line:
            funcs[name] = True
    summary = {}
    for family, (pick, want_hmma) in SASS_FAMILIES.items():
        uses = [hmma for name, hmma in funcs.items() if pick(name)]
        summary[family] = {"functions": len(uses), "with_HMMA": sum(uses)}
        require(bool(uses) and all(u == want_hmma for u in uses),
                f"SASS of {family}: HMMA in {sum(uses)} of {len(uses)} "
                f"functions, expected {'all' if want_hmma else 'none'}")
    return summary


# --- phase 3: each kernel against its plain version ---------------------------

def check_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Returns {entry name: partial kernel record} for the kernels line."""
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.kernels import stats
    from protopformer_tpu_torch.ops.rollout import masked_map_stats

    records = {}
    E = N * N
    keep = E - int(E * DISCARD)

    # K1 on a bf16 (B, N, 3C) qkv, both map storage modes: t bit-equal to
    # masked_map_stats on the kernel's own map, s within 1e-6 of that map's
    # masked row sums. The kernel sums the dots on tensor cores in another
    # order than the plain version, so a bf16 logit can move by one ulp and
    # with it that logit's row of the map. Against the plain version: the
    # map within one bf16 ulp of its largest entry and out within 2 bf16
    # ulps of max|out|; at most 1e-4 of the map's entries (or one row, N)
    # differ; t differs in at most max(1, B // 80) samples, each one whose
    # map differs. A wrong scale, a dropped bf16 rounding or a wrong row of
    # a band breaks these.
    if dev.type == "cuda":
        lib = _build.library()
        cluster = {
            "ctas_per_sample": lib.ppf_attention_block_stats_cluster_size(N),
            "resident_clusters": lib.ppf_attention_block_stats_active_clusters(
                N, C // H)}
        log(f"K1 launch at B={B}, N={N}: {B} clusters, {json.dumps(cluster)}")
        require(cluster["ctas_per_sample"] > 1
                and cluster["resident_clusters"] > 0,
                "K1: not a multi-CTA cluster launch")
    qkv = torch.randn((B, N, 3 * C), generator=gen).to(dev, torch.bfloat16)
    for exact in (False, True):
        mode = "exact" if exact else "speed"
        out, fmap, t, s = ac.fused_attention_block_stats(qkv, H, DISCARD, exact)
        p_out, p_map, p_t, _ = ac.block_stats_plain(qkv, H, keep, exact)
        own_t, _ = masked_map_stats(fmap, DISCARD, exact_discard=exact)
        own_s = stats.masked_row_sums(fmap.float(), t.float())
        torch.cuda.synchronize()
        res = k1_contract(out, fmap, t, s, p_out, p_map, p_t, own_t, own_s)
        log(f"K1 {mode}: {json.dumps(res)}")
        require(res["t_equal_own"],
                f"K1 {mode}: t differs from masked_map_stats on its own map")
        require(res["holds"] and res["t_only_where_map_differs"],
                f"K1 {mode}: outside its contract with the plain version")
        errs = {k: res["got"][k] for k in ("s", "map", "out")}
        map_bytes = 4 if exact else 2
        nbytes = (B * N * 3 * C * 2 + B * N * C * 2 + B * E * map_bytes
                  + B * 4 + B * N * 4)
        records[f"fused_attention_block_stats[{mode}]"] = dict(
            kernel="fused_attention_block_stats",
            source="protopformer_tpu_torch/csrc/attention_block_stats.cu",
            replaces="protopformer_tpu/kernels/attention_core.py:474",
            max_abs_err=max(errs.values()),
            ms=time_ms(lambda: ac.fused_attention_block_stats(
                qkv, H, DISCARD, exact)),
            plain_ms=time_ms(lambda: ac.block_stats_plain(qkv, H, keep, exact)),
            bound=bound(nbytes, (4.0 * B * N * N * C, BF16_FLOPS)),
        )

    # K3 in fp32 at N=197 (the parity path) with a prune-point policy
    qkv32 = torch.randn((B, N, 3 * C), generator=gen).to(dev)
    pol = torch.zeros((B, N))
    pol[:, 0] = 1.0
    for b in range(B):
        pol[b, 1 + torch.randperm(N - 1, generator=gen)[:81]] = 1.0
    pol = pol.to(dev)
    # K3 in bf16 at N=82 (block 11 after the gather), all-ones policy
    qkv82 = torch.randn((B, N_GATHERED, 3 * C), generator=gen).to(
        dev, torch.bfloat16)
    ones82 = torch.ones((B, N_GATHERED), device=dev)
    fmap32 = None
    for name, q, p, tol in (("fp32,N=197", qkv32, pol, 1e-5),
                            ("bf16,N=82", qkv82, ones82, 1e-2)):
        n = q.shape[1]
        out, fmap = ac.fused_attention_mean_padded(q, p, H, real_n=n)
        p_out, p_map = ac.mean_padded_plain(q, p, H, real_n=n)
        torch.cuda.synchronize()
        errs = {"out": max_err(out, p_out), "map": max_err(fmap, p_map)}
        log(f"K3 {name}: max abs err {json.dumps(errs)} "
            f"(tolerance out {tol}, map 1e-6)")
        require(errs["out"] <= tol and errs["map"] <= 1e-6,
                f"K3 {name}: outside tolerance")
        if q.dtype == torch.float32:
            fmap32 = fmap
        el = q.element_size()
        nbytes = (B * n * 3 * C * el + B * n * 4 + B * n * C * el
                  + B * n * n * 4)
        peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
        records[f"fused_attention_mean_padded[{name}]"] = dict(
            kernel="fused_attention_mean_padded",
            source="protopformer_tpu_torch/csrc/attention_mean.cu",
            replaces="protopformer_tpu/kernels/attention_core.py:231",
            max_abs_err=max(errs.values()),
            ms=time_ms(lambda: ac.fused_attention_mean_padded(q, p, H, n)),
            plain_ms=time_ms(lambda: ac.mean_padded_plain(q, p, H, n)),
            bound=bound(nbytes, (4.0 * B * n * n * C, peak)),
        )

    # K2 on the fp32 head-mean maps K3 just emitted (the parity path), one
    # sample over a cluster of CTAs
    if dev.type == "cuda":
        cluster = {"ctas_per_sample": lib.ppf_map_stats_cluster_size(N),
                   "resident_clusters": lib.ppf_map_stats_active_clusters(N, 0)}
        log(f"K2 launch at B={B}, N={N}: {B} clusters, {json.dumps(cluster)}")
        require(cluster["ctas_per_sample"] > 1
                and cluster["resident_clusters"] > 0,
                "K2: not a multi-CTA cluster launch")
    t, s = stats.fused_map_stats(fmap32, DISCARD, exact_discard=True)
    p_t, p_s = stats.map_stats_plain(fmap32, keep, prefix16=False)
    torch.cuda.synchronize()
    require(torch.equal(t, p_t), "K2: t differs from the plain version")
    err = max_err(s, p_s)
    log(f"K2 fp32: t bit-equal; max abs err {json.dumps({'s': err})} "
        "(tolerance s 1e-6)")
    require(err <= 1e-6, "K2: outside tolerance")
    nbytes = B * E * 4 + B * 4 + B * N * 4
    records["fused_map_stats[fp32]"] = dict(
        kernel="fused_map_stats",
        source="protopformer_tpu_torch/csrc/map_stats.cu",
        replaces="protopformer_tpu/kernels/stats.py:33",
        max_abs_err=err,
        ms=time_ms(lambda: stats.fused_map_stats(fmap32, DISCARD, True)),
        plain_ms=time_ms(lambda: stats.map_stats_plain(fmap32, keep, False)),
        # the work, not the algorithm: one comparison per entry for the
        # select and one for the masked row sums; the bytes term (the map
        # read once, t and s written once) is as before
        bound=bound(nbytes, (2.0 * B * E, FP32_FLOPS)),
    )
    return records


def _kept(norm_map: torch.Tensor) -> torch.Tensor:
    """Entries a normalized map kept through the discard: off-diagonal and
    > 0 (the identity blend makes every real diagonal entry > 0)."""
    eye = torch.eye(norm_map.shape[-1], dtype=torch.bool,
                    device=norm_map.device)
    return (norm_map > 0) & ~eye


def phase_ms(fn, reps: int = 5) -> dict:
    """Device ms per call of the two launches of a K4/K5 call, from a
    torch.profiler trace of ``reps`` calls (``profile_chunk``): the
    normalize (``normalize_kernel``) and the attention before it."""
    prof = profile_chunk(fn, reps=reps, top=4)
    phases = {"attention": 0.0, "normalize": 0.0}
    for k in prof["top"]:
        key = "normalize" if "normalize_kernel" in k["name"] else "attention"
        phases[key] += k["ms"]
    require(len(prof["top"]) == 2 and all(k["calls"] == 1 for k in prof["top"])
            and phases["normalize"] > 0,
            f"expected one attention and one normalize launch a call: {prof}")
    return phases


def check_core_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """K4 and K5 against their plain versions; returns partial records.

    K4 runs at the thresh forward's shapes (B=160, N=197) and at the
    kernel bench's (B=256, with its explicit all-ones policy); K5 at the
    bench's only (B=256, NP=256, real_n=197), on the operands the bench
    builds (``bench_kernels.bench_inputs``).

    The map is normalized after a k-th largest discard, where a one-ulp
    difference in the raw map can move an entry across the threshold.
    Each launch is held two ways: (a) against the plain
    normalize_attention_map (exact) of K3's raw map on the same qkv and
    policy (K4/K5 run K3's device code, so the raw map is the same): the
    kept entries identical, the map within 1e-6, K5's pads exactly 0;
    (b) against core_plain / core_padded_plain: out within 1e-5 (fp32) or
    one bf16 ulp of max|out| (bf16), the entries whose kept state differs
    counted (expected 0), the map within 1e-6 on every sample whose kept
    entries agree."""
    from protopformer_tpu_torch.cli.bench_kernels import bench_inputs
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.ops.rollout import normalize_attention_map

    lib = _build.library()
    records = {}
    qkv = torch.randn((B, N, 3 * C), generator=gen).to(dev, torch.bfloat16)
    qkv32 = torch.randn((B, N, 3 * C), generator=gen).to(dev)
    pol = torch.zeros((B, N))
    pol[:, 0] = 1.0
    for b in range(B):
        pol[b, 1 + torch.randperm(N - 1, generator=gen)[:81]] = 1.0
    pol = pol.to(dev)
    ones = torch.ones((B, N), device=dev)
    bench = bench_inputs(dev)
    cases = (
        # name, kernel's qkv, kernel's policy (None: all ones), real_n
        ("fused_attention_core[bf16,ones]", qkv, None, N),
        ("fused_attention_core[fp32,policy]", qkv32, pol, N),
        ("fused_attention_core[bf16,bench]", bench["qkv"], bench["policy"],
         N),
        ("fused_attention_core_padded[bf16,bench]", bench["qkv_pad"],
         bench["policy_pad"], N),
    )
    for name, q, p, n in cases:
        bq, np_ = q.shape[:2]
        if "padded" in name:
            kernel = lambda: ac.fused_attention_core_padded(q, p, H, n)
            plain = lambda: ac.core_padded_plain(q, p, H, n)
        else:
            kernel = lambda: ac.fused_attention_core(q, p, H)
            plain = lambda: ac.core_plain(q, p, H)
        out, fmap = kernel()
        p_out, p_map = plain()
        _, raw = ac.fused_attention_mean_padded(
            q, ones[:bq] if p is None else p, H, n)
        want = normalize_attention_map(raw[:, :n, :n], DISCARD, 0.2, True)
        torch.cuda.synchronize()
        same_kept = torch.equal(_kept(fmap[:, :n, :n]), _kept(want))
        pads = float(fmap[:, n:].abs().sum() + fmap[:, :, n:].abs().sum())
        kept_diff = _kept(fmap) != _kept(p_map)
        agree = ~kept_diff.flatten(1).any(dim=1)
        fp32 = q.dtype == torch.float32
        out_tol = 1e-5 if fp32 else 2.0 ** -8 * float(p_out.float().abs().max())
        errs = {"map_vs_k3_normalize": max_err(fmap[:, :n, :n], want),
                "out": max_err(out[:, :n], p_out[:, :n]),
                "map_vs_plain": (max_err(fmap[agree], p_map[agree])
                                 if bool(agree.any()) else None)}
        log(f"{name} B={bq} NP={np_}: kept entries identical to the plain "
            f"normalize of K3's map: {same_kept}; pad sum {pads!r}; entries "
            f"whose kept state differs from the plain version: "
            f"{int(kept_diff.sum())} (in {int((~agree).sum())} of {bq} "
            f"samples); max abs err {json.dumps(errs)} (tolerance map 1e-6, "
            f"out {out_tol!r})")
        require(same_kept and pads == 0.0
                and errs["map_vs_k3_normalize"] <= 1e-6,
                f"{name}: differs from the plain normalize of K3's map")
        require(errs["out"] <= out_tol, f"{name}: out outside tolerance")
        require(errs["map_vs_plain"] is not None
                and errs["map_vs_plain"] <= 1e-6,
                f"{name}: map outside tolerance of the plain version")
        # the normalize: one sample's real block over a cluster of CTAs
        cluster = {"ctas_per_sample": lib.ppf_attention_core_cluster_size(n),
                   "resident_clusters":
                       lib.ppf_attention_core_active_clusters(n, np_)}
        phases = phase_ms(kernel)
        log(f"{name}: normalize launch {bq} clusters, {json.dumps(cluster)}; "
            f"device ms per call by phase {json.dumps(phases)}")
        require(cluster["ctas_per_sample"] > 1
                and cluster["resident_clusters"] > 0,
                f"{name}: the normalize is not a multi-CTA cluster launch")
        el = q.element_size()
        nbytes = (bq * np_ * 3 * C * el + bq * np_ * C * el
                  + bq * np_ * np_ * 4 + (0 if p is None else bq * np_ * 4))
        peak = FP32_FLOPS if fp32 else BF16_FLOPS
        records[name] = dict(
            kernel=name.split("[")[0],
            source="protopformer_tpu_torch/csrc/attention_core.cu",
            replaces=("protopformer_tpu/kernels/attention_core.py:126"
                      if "padded" in name else
                      "protopformer_tpu/kernels/attention_core.py:43"),
            max_abs_err=max(v for v in errs.values() if v is not None),
            ms=time_ms(kernel),
            plain_ms=time_ms(plain),
            # the work, not the algorithm: the products over all NP rows
            # and columns; over the real block one comparison per entry for
            # the select and one operation for the blend. The bytes term
            # (qkv, policy read once; out, the map written once) is as before
            bound=bound(nbytes, (4.0 * bq * np_ * np_ * C, peak),
                        (2.0 * bq * n * n, FP32_FLOPS)),
        )
    return records


# --- phase 4: serving in three modes ---------------------------------------------

def model_configs():
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset

    ppnet = PPNetConfig()  # 2000 + 2000 prototypes of width 192, 200 classes
    modes = {
        "bf16_speed": (backbone_preset("deit_tiny_patch16_224",
                                       rollout_exact_discard=False),
                       torch.bfloat16),
        "bf16_exact": (backbone_preset("deit_tiny_patch16_224"),
                       torch.bfloat16),
        "fp32_parity": (backbone_preset("deit_tiny_patch16_224"),
                        torch.float32),
    }
    return ppnet, modes


def expected_launches(mode: str, chunks: int, depth: int = 12) -> dict:
    """Kernel launches of ``chunks`` forwards with the prune at the last
    block: bf16 runs K1 on blocks 0-10 and K3 on the gathered block 11;
    fp32 runs K3 on every block and K2 on blocks 0-10."""
    pre = depth - 1
    none = {"fused_attention_core": 0, "fused_attention_core_padded": 0}
    if mode.startswith("bf16"):
        return {"fused_attention_block_stats": pre * chunks,
                "fused_map_stats": 0,
                "fused_attention_mean_padded": chunks, **none}
    return {"fused_attention_block_stats": 0,
            "fused_map_stats": pre * chunks,
            "fused_attention_mean_padded": depth * chunks, **none}


def profile_forward(engine, reps: int = 3, top: int = 8) -> dict:
    """``profile_chunk`` of one serving chunk's forward."""
    chunk = torch.zeros((engine.batch_size, 224, 224, 3), dtype=torch.uint8,
                        device=engine.device)
    engine.warmup()
    return profile_chunk(lambda: engine._forward(chunk), reps, top)


def profile_chunk(forward, reps: int = 3, top: int = 8) -> dict:
    """Where one chunk's ``forward()`` spends its time: its host-clock time,
    and from a torch.profiler trace of ``reps`` forwards the device-busy
    time (the union of the kernels' intervals), the idle share of the
    traced window and the largest kernels by device time, all per chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(reps):
        forward()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()
    # device activity only; "Command Buffer Full" marks a host stall
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    require(bool(spans), "the profile recorded no device activity")
    by_name, busy_us, run_start, run_end = {}, 0.0, None, None
    for start, end, name in spans:
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, calls + 1)
        if run_end is None or start > run_end:
            busy_us += 0.0 if run_end is None else run_end - run_start
            run_start, run_end = start, end
        else:
            run_end = max(run_end, end)
    busy_us += run_end - run_start
    window_us = max(end for _, end, _ in spans) - spans[0][0]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "chunk_ms": wall_ms,
        "device_busy_ms": busy_us / reps / 1e3,
        "idle_share": 1.0 - busy_us / window_us,
        "top": [{"name": name[:70], "ms": us / reps / 1e3,
                 "calls": calls // reps} for name, (us, calls) in ranked],
    }


def serve(dev: torch.device, state_dict, rng: np.random.Generator) -> dict:
    """Returns {mode: {"launches": {...}, "img_per_sec": x}}."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.serving import ServingEngine

    ppnet, modes = model_configs()
    results = {}
    for mode, (backbone, dtype) in modes.items():
        engine = ServingEngine(backbone, ppnet, state_dict, batch_size=B,
                               compute_dtype=dtype, with_attn=True,
                               device=dev)
        requests = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
                    for n in REQUESTS]
        kernels.reset_launch_counts()
        answers = [engine(imgs) for imgs in requests]
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        chunks = sum(-(-n // B) for n in REQUESTS)
        want = expected_launches(mode, chunks)
        log(f"serve {mode}: launches {json.dumps(launches)}")
        require(launches == want, f"serve {mode}: expected launches {want}")
        for n, res in zip(REQUESTS, answers):
            require(res.logits.shape == (n, ppnet.num_classes)
                    and res.cls_token_attn.shape == (n, 196),
                    f"serve {mode}: wrong shapes for {n} images")
            require(bool(np.isfinite(res.logits).all()
                         and np.isfinite(res.cls_token_attn).all()),
                    f"serve {mode}: non-finite output for {n} images")
            require(bool((res.top_class == res.logits.argmax(-1)).all()),
                    f"serve {mode}: top_class is not the argmax")
        probe = engine.throughput_probe(n_images=PROBE_IMAGES, reps=3)
        log(f"serve {mode}: throughput_probe {json.dumps(probe)}")
        log(f"serve {mode}: profile {json.dumps(profile_forward(engine))}")
        results[mode] = {"launches": launches,
                         "img_per_sec": probe["img_per_sec"]}
        del engine
    return results


# --- phase 5: the card against the CPU -----------------------------------------

def top81(attn: np.ndarray):
    return [set(np.argsort(-row)[:81].tolist()) for row in attn]


def selection(attn: np.ndarray, ref_attn: np.ndarray):
    """Per sample: how many of the reference's top-81 tokens ``attn``'s
    top-81 keeps, and the lowest reference rank among those it drops."""
    ref_order = np.argsort(-ref_attn, axis=-1)
    overlap, worst_drop = [], []
    for b, got in enumerate(top81(attn)):
        want = set(ref_order[b, :81].tolist())
        rank = {int(tok): r for r, tok in enumerate(ref_order[b])}
        overlap.append(len(want & got))
        worst_drop.append(min((rank[t] for t in want - got), default=None))
    return overlap, worst_drop


def card_vs_cpu(dev: torch.device, state_dict,
                rng: np.random.Generator) -> None:
    from protopformer_tpu_torch.serving import ServingEngine

    ppnet, modes = model_configs()
    imgs = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    backbone, _ = modes["fp32_parity"]

    def run(bk, dtype, device):
        return ServingEngine(bk, ppnet, state_dict, batch_size=2,
                             compute_dtype=dtype, with_attn=True,
                             device=device)(imgs)

    cpu = run(backbone, torch.float32, "cpu")
    card = run(backbone, torch.float32, dev)
    err = float(np.abs(card.logits - cpu.logits).max())
    same = [a == b for a, b in zip(top81(card.cls_token_attn),
                                   top81(cpu.cls_token_attn))]
    log(f"card vs cpu fp32: logits max abs err {err!r}; "
        f"same top-81 set {same}")
    require(err <= 1e-4 and all(same), "fp32 card vs CPU: outside contract")
    # bf16, both discard modes, against the CPU's fp32 forward: the contract
    # of tests/test_torch_model.py (selection) and its logits bound
    atol = 2e-2 * float(np.abs(cpu.logits).max())
    for mode in ("bf16_speed", "bf16_exact"):
        bf16 = run(modes[mode][0], torch.bfloat16, dev)
        overlap, worst_drop = selection(bf16.cls_token_attn,
                                        cpu.cls_token_attn)
        excess = np.abs(bf16.logits - cpu.logits) - (
            atol + 2e-2 * np.abs(cpu.logits))
        log(f"card {mode} vs cpu fp32: top-81 overlap {overlap}, lowest "
            f"fp32 rank dropped {worst_drop}; logits max abs err "
            f"{float(np.abs(bf16.logits - cpu.logits).max())!r} (bound rtol "
            f"2e-2, atol {atol!r})")
        require(min(overlap) >= 74, f"{mode} selection: overlap below 74/81")
        require(all(r is None or r >= 64 for r in worst_drop),
                f"{mode} selection: dropped a token of fp32 rank below 64")
        require(bool((excess <= 0).all()), f"{mode} logits: outside bound")


# --- phase 4b: the threshold-pruning forward (eager rollout) ----------------------

THRESH_LAUNCHES = {"fused_attention_block_stats": 0, "fused_map_stats": 0,
                   "fused_attention_mean_padded": 1, "fused_attention_core": 11,
                   "fused_attention_core_padded": 0}


def backbone_from(state_dict, backbone_cfg, dtype, device):
    """The PPNet state dict's ``features.*`` in a DeiTBackbone."""
    from protopformer_tpu_torch.models import DeiTBackbone

    model = DeiTBackbone(backbone_cfg, dtype)
    model.load_state_dict({k[len("features."):]: v
                           for k, v in state_dict.items()
                           if k.startswith("features.")}, strict=True)
    return model.to(device).eval()


def thresh(dev: torch.device, state_dict, rng: np.random.Generator) -> dict:
    """masked_forward_thresh at full depth and B=160, bf16 exact and fp32,
    each with the launch counters (K4 on blocks 0-10, K3 on block 11, per
    forward), then on the first 2 images against the CPU: fp32 matches the
    CPU's fp32 (cls_token_attn within 1e-5, x within 1e-4); against the
    CPU's bf16 and fp32 forwards, bf16 exact keeps x within serving's bf16
    bound (rtol 2e-2 plus 2e-2 * max|ref|) and cls_token_attn within
    serving's selection contract.
    Returns {path: {"launches": ...}}."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.serving import no_tf32

    ppnet, modes = model_configs()
    reserve = ppnet.reserve_layer_nums
    P = 196
    results = {}

    def forward(model, x, token_attn):
        with torch.inference_mode():
            return model.masked_forward_thresh(*model.embed_all(x), token_attn,
                                               reserve)

    x = torch.from_numpy(rng.normal(size=(B, 224, 224, 3)).astype(np.float32))
    token_attn = torch.from_numpy(
        rng.uniform(0, 2.0 / P, size=(B, P)).astype(np.float32))
    paths = (("thresh_bf16_exact", modes["bf16_exact"][0], torch.bfloat16),
             ("thresh_fp32", modes["fp32_parity"][0], torch.float32))
    # the CPU runs the kernels' plain versions
    cpu = {path: forward(backbone_from(state_dict, bk, dtype, "cpu"), x[:2],
                         token_attn[:2])
           for path, bk, dtype in paths}
    x, token_attn = x.to(dev), token_attn.to(dev)
    card = {}
    for path, bk, dtype in paths:
        model = backbone_from(state_dict, bk, dtype, dev)
        kernels.reset_launch_counts()
        # fp32 as ServingEngine runs it (ROADMAP F1); bf16 as a caller would
        with no_tf32() if dtype == torch.float32 else contextlib.nullcontext():
            out, attn = forward(model, x, token_attn)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"{path}: launches {json.dumps(launches)}")
        require(launches == THRESH_LAUNCHES,
                f"{path}: expected launches {THRESH_LAUNCHES}")
        require(out.shape == (B, 1 + P, C) and attn.shape == (B, P)
                and bool(torch.isfinite(out.float()).all())
                and bool(torch.isfinite(attn).all())
                and bool((attn >= 0).all()),
                f"{path}: wrong shape or non-finite output")
        if dtype == torch.bfloat16:
            prof = profile_chunk(lambda: forward(model, x, token_attn))
            log(f"{path}: profile {json.dumps(prof)}")
        card[path] = (out[:2].float().cpu(), attn[:2].cpu())
        results[path] = {"launches": launches}
        del model

    got_x, got_attn = card["thresh_fp32"]
    ref_x, ref_attn = cpu["thresh_fp32"]
    errs = {"cls_token_attn": max_err(got_attn, ref_attn),
            "x": max_err(got_x, ref_x)}
    log(f"thresh fp32 card vs cpu: max abs err {json.dumps(errs)} "
        "(tolerance cls_token_attn 1e-5, x 1e-4)")
    require(errs["cls_token_attn"] <= 1e-5 and errs["x"] <= 1e-4,
            "thresh fp32 card vs CPU: outside tolerance")

    def bf16_bound(what: str, got: torch.Tensor, ref: torch.Tensor) -> float:
        """Serving's bf16 value bound: rtol 2e-2 plus 2e-2 * max|ref|."""
        atol = 2e-2 * float(ref.abs().max())
        excess = float(((got - ref).abs() - (atol + 2e-2 * ref.abs())).max())
        log(f"thresh bf16 exact {what}: max abs err {max_err(got, ref)!r}, "
            f"largest excess over the bound {excess!r} (bound rtol 2e-2, "
            f"atol {atol!r})")
        return excess

    # bf16 exact against the CPU's bf16 forward (the same route in the same
    # dtype) and its fp32 forward: x by the value bound; cls_token_attn, a
    # ranking score, by serving's selection contract, its value error
    # recorded (the hard discard flips entries near the threshold wherever
    # the raw maps differ by an ulp, whichever the reference's dtype)
    got_x, got_attn = card["thresh_bf16_exact"]
    cpu_bf16 = tuple(t.float() for t in cpu["thresh_bf16_exact"])
    for ref, (cpu_x, cpu_attn) in (("cpu bf16", cpu_bf16),
                                   ("cpu fp32", (ref_x, ref_attn))):
        require(bf16_bound(f"x, card vs {ref}", got_x, cpu_x) <= 0,
                f"thresh bf16 exact x: outside bound of the {ref} forward")
        bf16_bound(f"cls_token_attn, card vs {ref} (recorded)", got_attn,
                   cpu_attn)
        overlap, worst_drop = selection(got_attn.numpy(), cpu_attn.numpy())
        log(f"thresh bf16 exact vs {ref}: top-81 overlap {overlap}, lowest "
            f"rank dropped {worst_drop}")
        require(min(overlap) >= 74 and all(r is None or r >= 64
                                           for r in worst_drop),
                f"thresh bf16 exact selection against the {ref} forward: "
                "outside contract")
    return results


# --- phase 4c: the kernel bench ----------------------------------------------------

def bench(dev: torch.device) -> dict:
    """cli.bench_kernels.run on the card; K5 must have launched."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.cli import bench_kernels

    kernels.reset_launch_counts()
    res = bench_kernels.run(dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"bench_kernels: {json.dumps(res)}; launches {json.dumps(launches)}")
    require(launches["fused_attention_core_padded"] > 0
            and launches["fused_attention_core"] > 0,
            "bench_kernels: K4 or K5 never launched")
    return {"bench": {"launches": launches}}


# --- main ----------------------------------------------------------------------

def main() -> int:
    if not (ROOT / "protopformer_tpu_torch").is_dir():
        print("chip_smoke.py: the protopformer_tpu_torch package is not "
              f"beside this script in {ROOT}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 3
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.models import construct_ppnet

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(smi)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    info = _build.build(verbose=True)
    log(f"build: {info['seconds']:.1f} s")
    ptxas = {src: [ln.strip() for ln in rep.splitlines()
                   if "Used" in ln or "spill" in ln]
             for src, rep in info["ptxas"].items()}
    log("ptxas: " + json.dumps(ptxas))
    log("sass: " + json.dumps(check_sass()))

    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    records = check_kernels(dev, gen)
    records.update(check_core_kernels(dev, gen))
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    ppnet, modes = model_configs()
    model = construct_ppnet(modes["fp32_parity"][0], ppnet, torch.float32,
                            generator=torch.Generator().manual_seed(1))
    state_dict = model.state_dict()
    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    served = serve(dev, state_dict, rng)
    log(f"serving: {time.perf_counter() - t0:.1f} s")
    paths = dict(served)
    t0 = time.perf_counter()
    paths.update(thresh(dev, state_dict, rng))
    log(f"thresh forward: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.update(bench(dev))
    log(f"kernel bench: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    card_vs_cpu(dev, state_dict, rng)
    log(f"card vs cpu: {time.perf_counter() - t0:.1f} s")

    # launches of each record's kernel on the paths that run it
    per_record_mode = {
        "fused_attention_block_stats[speed]": ["bf16_speed"],
        "fused_attention_block_stats[exact]": ["bf16_exact"],
        "fused_attention_mean_padded[fp32,N=197]": ["fp32_parity"],
        "fused_attention_mean_padded[bf16,N=82]": ["bf16_speed",
                                                   "bf16_exact"],
        "fused_map_stats[fp32]": ["fp32_parity"],
        "fused_attention_core[bf16,ones]": ["thresh_bf16_exact"],
        "fused_attention_core[fp32,policy]": ["thresh_fp32"],
        "fused_attention_core[bf16,bench]": ["bench"],
        "fused_attention_core_padded[bf16,bench]": ["bench"],
    }
    line = []
    for name, rec in records.items():
        launches = sum(paths[m]["launches"][rec["kernel"]]
                       for m in per_record_mode[name])
        require(launches > 0, f"{name}: never launched on the main path")
        bound_ms, bound_by = rec["bound"]
        line.append({
            "name": name, "route": "cuda", "source": rec["source"],
            "replaces": rec["replaces"], "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })
    require(set(kernels.WRAPPERS) == {r["kernel"] for r in records.values()},
            "a kernel of the path has no record")
    log("serving img/s: " + json.dumps(
        {m: r["img_per_sec"] for m, r in served.items()}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
