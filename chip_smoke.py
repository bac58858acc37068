#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``protopformer_tpu_torch``) on one GPU.

Run from anywhere, with the package beside this script, on a machine with a
CUDA card (an H100 is the target):

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernels from protopformer_tpu_torch/csrc (one nvcc per
     source, all started together), print each kernel's ptxas report, and
     from cuobjdump's SASS check that K1's and K3's bf16 kernels (the long
     ones from 257 tokens on too) use the tensor cores (HMMA) and K3's fp32
     kernels do not;
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
     comes from CUDA events (the attention as K3's call on the same
     operands);
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
  4d. CaiT: one ServingEngine per mode over seeded random CaiT-XXS-24
     weights (24 talking-heads blocks, 2 class-attention blocks, the same
     prototypes and classes, reserve at class-attention block 1 keeping
     81) answers the same requests; the launch counters must read 0 for
     every kernel (its blocks and its signed statistics run no kernel of
     kernels/); a throughput_probe of 1,600 images, 2 reps, and a profile
     of one chunk; then on 2 images the card against the CPU: fp32
     cls_token_attn within 1e-5, logits within 1e-4 and the same top-81;
     bf16 speed and exact keep at least 76 of the CPU fp32 top-81, drop
     none of fp32 rank below 60, and keep the logits within phase 5's
     bound;
  4e. training: the DeiT-Tiny/16@224 PPNet at the CUB preset
     (scripts/train_cub.sh: 2000 x 192 local and 2000 global prototypes,
     200 classes, reserve 81 at block 11, PPC on, AdamW in three groups,
     EMA 0.99996), B=128, seeded weights and seeded [0, 1] images and
     labels on the card, through the port's train entry points
     (make_optimizer, create_train_state, make_train_step): in bf16 and in
     fp32 (TF32 off) 3 warm-up steps, one step whose launch counters must
     read K2 x 11 and no attention kernel, 10 timed steps (ms/step, img/s)
     and a profile of 2 steps; 20 steps on one fixed batch from the
     preset's first full-LR epoch must lower the loss; one fp32 step at
     B=4, drop path 0, on the card and on the CPU from the same weights:
     loss within 1e-5, every gradient within 2e-4 * max|g| + 1e-7, the
     card's parameters after the AdamW step within 1e-6 of the CPU's AdamW
     step on the card's gradients (``step_contract``), and the parameters'
     difference from the CPU's own step recorded; make_eval_step +
     evaluate over two batches, the last ragged, launching K1 x 11 and
     K3 x 1 per bf16 batch; CaiT-XXS-24: 2 bf16 train steps at B=16, loss
     finite, no kernel launched;
  4f. DeiT-Small/16@224 and DeiT-Base/16@224 PPNets at the CUB preset
     (2000 + 2000 prototypes of width 192, 200 classes, reserve 81 at block
     11; seeded weights), B=160: DeiT-S served in the three modes, DeiT-B in
     bf16 speed and fp32, each with the launch counters on one chunk, a
     throughput_probe and a profile of one chunk; K1 (6 and 12 heads, by
     k1_contract, whose differing-entries limit grows with the heads), K3
     and K2 against their plain versions on the model's
     own qkv and maps, timed and bounded; fp32 card vs CPU on 2 images
     (logits within 1e-4, the same top-81) and DeiT-S's bf16 modes by
     phase 5's contract against the CPU's fp32 forward (DeiT-B's reading
     recorded, as are the card's bf16 against the CPU's bf16 and the CPU's
     bf16 against its fp32); DeiT-S push_forward (ServingEngine.push_forward) at B=160 in
     bf16 exact, launching one eval forward's kernels, its cls_token_attn
     bit-equal to the eval forward's, and in fp32 on 2 images within 1e-4
     of the CPU's proto_acts; the kernel-off structure (use_pallas="off")
     on DeiT-Tiny, B=160, in three cases: bf16 speed with K2 on the
     headloop's bf16 maps (11 a chunk; K2's speed mode against its plain
     version on the path's own map; logits within phase 5's bound of the
     kernel-on fp32 forward, selections recorded), fp32 with
     stats_kernel="off" and
     rollout_discard_sample=4, fp32 with rollout_stats_batched="on" (no
     kernel; logits within 1e-4 of the kernel-on fp32 forward, the same
     top-81), each with img/s; BaseNet and DistilledDeiT over DeiT-Tiny,
     B=32, fp32: no kernel launched, logits of 8 images within 1e-4 of the
     CPU's;
  4g. token counts above 256: the DeiT-B/16@384 PPNet (577 tokens, 12
     heads) at the CUB preset, seeded weights, B=160, served in the three
     modes as in 4f (bf16: K1 x 11 at N=577 and K3 x 1 at N=82 a chunk;
     fp32: K3 x 12 and K2 x 11 at N=577); K1 (speed and exact, by
     k1_contract), K3 fp32 and K2 fp32 at N=577 against their plain
     versions on the model's own operands; fp32 card vs CPU on 2 images
     (logits within 1e-4, the same top-81), the bf16 modes' readings
     recorded; masked_forward_thresh at 384 in bf16 exact and fp32 (K4 x 11
     at N=577 and K3 x 1 a forward), held as 4b holds it but for bf16
     exact's selection against the CPU's bf16 forward, recorded beside
     bf16_witness's 160-image readings, with each K4 on its forward's own
     qkv held as check_core_kernels holds K4; the kernel
     bench at 577 tokens (K5 on real 577 in NP 640, held the same way);
     K3's bf16 long kernel (K4's and K5's attention phase) on K4's
     operands at 577 and on K5's bench operands, with its blocks an SM and
     shared memory (k3_bf16_long_reading); the map select's readings
     (select_reading): K2 at 577 on the fp32 serving map beside a two-call
     torch.kthvalue reference, K1's select alone on K1's stored map, and
     K4/K5's normalize phase at 577 and 640 with its bound (the map's
     round trip); then deit_tiny_patch2_32 (257 tokens, 3 heads) in the
     three modes as DeiT-B/16@384;
  4h. past 640 tokens, the routes above the kernels' old limit:
     DeiT-Tiny/16 at 448 px (785 tokens, the CUB preset's head, seeded
     weights, B=160) served in the three modes as in 4g (bf16: K1 x 11 at
     N=785, its heads kernel's accumulator in device memory, and K3 x 1 at
     N=82; fp32: K3 x 12, on its global route, and K2 x 11 at N=785), fp32
     card vs CPU on 2 images (logits within 1e-4, the same top-81), the
     bf16 readings recorded; masked_forward_thresh at 448 (K4 x 11 at 785),
     bf16 exact's selection recorded against both CPU forwards beside
     bf16_witness's 160-image readings; the kernel bench at real 785 in NP
     896 (K5); DeiT-Tiny/16 at 512 px (1,025 tokens, the map select's
     bands read in place) in bf16 speed and fp32; each kernel held against
     its plain version on the path's own operands as in 4g;
  4i. the data layer feeding the trainer: a seeded CUB-200-2011 tree of
     JPEGs at the dataset's sizes written under build/ (200 classes, 3
     train and 1 test image each, with images.txt,
     image_class_labels.txt, train_test_split.txt and
     bounding_boxes.txt), build_dataset_index("CUB2011U"), main_train.py's
     train transform at 224 (RandAugment rand-m9-mstd0.5-inc1,
     RandomErasing 0.25) through the native decoder where it builds, else
     PIL, HostDataLoader at B=128 with 8 workers (the loader alone timed
     over an epoch), train_one_epoch of the DeiT-Tiny/16@224 CUB-preset
     PPNet in bf16 over 3 epochs at the preset's full LR, one step with
     MixupCutmix (main_train.py's cutmix), K2 x 11 a step, the mean loss
     of the last epoch below the first's; one loader-fed step profiled
     (idle share); evaluate over the eval loader (K1 x 11 + K3 x 1 a
     batch, the last padded); prints the loader's img/s, the fed train
     step's img/s and idle share, and whether the native path ran;
  4j. the offline user path through the CLIs, in process: the same seeded
     CUB tree plus parts/parts.txt and parts/part_locs.txt (15 seeded parts
     an image, a fifth invisible) and a seeded timm-layout DeiT-Tiny/16@224
     .pth ({"model": ...}, module.-prefixed, a 1000-class head);
     cli.train with cli/presets/train_cub.sh's flags at B=128,
     --pretrained_ckpt, 2 epochs saving each (K2 x 11 a step, K1 x 11 +
     K3 x 1 an eval batch), then --resume <root> for a third epoch, then
     --eval --resume <epoch 2's file>, which must reproduce epoch 2's
     logged acc1 and loss exactly; cli.export --use_ema, whose file loads
     with weights_only=True and equals the checkpoint's model_ema;
     ServingEngine serving 160 images from it (K1 x 11 + K3 x 1);
     cli.visualize slim_gaussian over 2 classes, with --use_gauss where
     matplotlib imports (the expected file count) and cli.eval_interpretability on the tree, each fp32 on
     the card (K3 x 12 + K2 x 11 a batch), the consistency score equal to
     the same CLI's on the CPU; prints the CLI's fed img/s per epoch, the
     checkpoint saves' seconds, the tools' img/s (host clock) and push's
     fp32 img/s on a device-resident batch of 160 (CUDA events);
  4k. several cards and the serving options: the CUB preset's DeiT-Tiny/16
     PPNet (drop path 0, fp32 with TF32 off) trained data-parallel at a
     global B=128 on a device-resident batch, by one process a card over
     NCCL (a group of one on a one-card machine) and, with fewer than two
     cards, by two gloo ranks sharing card 0 (this script re-run with
     --ddp-worker; each rank killed after 300 s): the backend each ran,
     the first step's all-reduced loss equal on every rank and within 1e-5
     of the one-process card step on the global batch, the gradients and
     the AdamW step by step_contract, K2 x 11 a rank a step, ms/step over
     10 steps; the mesh ServingEngine (every card, or card 0 twice) in
     fp32 at B=160 a device against the one-device engine (logits within
     1e-5, the same top-81 and top_class; a chunk launches each kernel
     once a device) with both img/s; bf16 speed serving plain, int8
     (quantize="int8") and with ln_stats "mxu" and "compute" at B=160,
     each against the fp32 engine (phase 5's contract on 2 images, the
     160-image readings recorded), launching K1 x 11 + K3 x 1 a chunk, with
     its img/s; a profile of an int8 chunk, and a utils.profiling.trace of
     one int8 chunk whose file holds its annotate span; every line with
     the card's name and power limit;
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
import importlib.util
import json
import math
import os
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
CAIT_PROBE_IMAGES = 160 * 10
TRAIN_B = 128  # scripts/train_cub.sh's default batch
# CUB-200-2011's 5,994 training images in full batches of 128
TRAIN_STEPS_PER_EPOCH = 5994 // TRAIN_B


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


def k1_contract(out, fmap, t, s, p_out, p_map, p_t, own_t, own_s,
                heads: int = 3) -> dict:
    """K1 against the plain version, as ``check_kernels`` describes; returns
    the readings, the limits and whether each holds. The differing entries
    come from logits that round one bf16 ulp the other way, and there are
    ``heads`` * B * N^2 logits: the count's limit, 1e-4 of the map's
    entries at 3 heads, grows with ``heads`` / 3 (the value limits are in
    ulps of the maps' own largest entries already)."""
    B, N = fmap.shape[:2]
    map_diff = (fmap != p_map).flatten(1)
    t_diff = t != p_t.to(t.dtype)
    got = {"s": max_err(s, own_s), "map": max_err(fmap, p_map),
           "out": max_err(out, p_out),
           "map_entries_differ": int(map_diff.sum()),
           "t_differ": int(t_diff.sum())}
    limit = {"s": 1e-6, "map": bf16_ulp(p_map), "out": 2 * bf16_ulp(p_out),
             "map_entries_differ": max(int(1e-4 * fmap.numel() * heads / 3),
                                       N),
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
    # the long kernels (from 257 tokens on)
    "K1 block_stats_long_kernel (bf16)": (
        lambda n: "block_stats_long_kernel" in n, True),
    "K3 mean_long_kernel (bf16)": (
        lambda n: "bf16k" in n and "mean_long_kernel" in n, True),
    "K3 mean_long_kernel (fp32)": (
        lambda n: "f32k" in n and "mean_long_kernel" in n, False),
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
    # at the serving batch (fp32 parity) and the train batch (B=128)
    for name, m in (("fused_map_stats[fp32]", fmap32),
                    ("fused_map_stats[fp32,B=128]",
                     fmap32[:TRAIN_B].contiguous())):
        bm = m.shape[0]
        t, s = stats.fused_map_stats(m, DISCARD, exact_discard=True)
        p_t, p_s = stats.map_stats_plain(m, keep, prefix16=False)
        torch.cuda.synchronize()
        require(torch.equal(t, p_t),
                f"{name}: t differs from the plain version")
        err = max_err(s, p_s)
        log(f"{name}: t bit-equal; max abs err {json.dumps({'s': err})} "
            "(tolerance s 1e-6)")
        require(err <= 1e-6, f"{name}: outside tolerance")
        nbytes = bm * E * 4 + bm * 4 + bm * N * 4
        records[name] = dict(
            kernel="fused_map_stats",
            source="protopformer_tpu_torch/csrc/map_stats.cu",
            replaces="protopformer_tpu/kernels/stats.py:33",
            max_abs_err=err,
            ms=time_ms(lambda: stats.fused_map_stats(m, DISCARD, True)),
            plain_ms=time_ms(lambda: stats.map_stats_plain(m, keep, False)),
            # the work, not the algorithm: one comparison per entry for the
            # select and one for the masked row sums; the bytes term (the
            # map read once, t and s written once) is as before
            bound=bound(nbytes, (2.0 * bm * E, FP32_FLOPS)),
        )
    return records


def _kept(norm_map: torch.Tensor) -> torch.Tensor:
    """Entries a normalized map kept through the discard: off-diagonal and
    > 0 (the identity blend makes every real diagonal entry > 0)."""
    eye = torch.eye(norm_map.shape[-1], dtype=torch.bool,
                    device=norm_map.device)
    return (norm_map > 0) & ~eye


def phase_ms(kernel, attention, reps: int = 5) -> dict:
    """Device ms per call of a K4/K5 call and of its two launches, after
    holding that a call is those two launches.

    A torch.profiler trace of ``reps`` calls holds the structure: its
    host-side runtime records are, call after call, one plain launch
    (``cudaLaunchKernel``: the attention) and one cluster launch
    (``cudaLaunchKernelExC``: the normalize) and nothing else that puts
    work on the card (no other launch, copy or fill), and every device
    record it keeps is K3's attention (``mean_``) or ``normalize_kernel``.
    It does not count the device records: the tracer drops those it
    places outside its capture window, more the longer the process has
    run (its "Out-of-range" count; late in this script 7-9 of 10, PERF.md
    §7). The times are CUDA events (``time_ms``): the call, the attention
    as ``attention()`` (K3's call on the same operands: the same device
    code) and the normalize as the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernel()
        torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    work = [e.name for e in events if e.device_type == DeviceType.CPU
            and any(w in e.name for w in ("Launch", "Memcpy", "Memset"))]
    device = {e.name for e in events if e.device_type == DeviceType.CUDA}
    kept = sum(e.device_type == DeviceType.CUDA for e in events)
    require(work == ["cudaLaunchKernel", "cudaLaunchKernelExC"] * reps
            and all("mean_" in n or "normalize_kernel" in n for n in device),
            f"expected one attention and one normalize launch a call: host "
            f"records {work}, device records {sorted(device)}")
    total, attn = time_ms(kernel), time_ms(attention)
    return {"total": total, "attention": attn, "normalize": total - attn,
            "device_records_kept": f"{kept} of {2 * reps}"}


def check_core_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """K4 and K5 against their plain versions; returns partial records.

    K4 runs at the thresh forward's shapes (B=160, N=197) and at the
    kernel bench's (B=256, with its explicit all-ones policy); K5 at the
    bench's only (B=256, NP=256, real_n=197), on the operands the bench
    builds (``bench_kernels.bench_inputs``). Each case is held by
    ``core_record``."""
    from protopformer_tpu_torch.cli.bench_kernels import bench_inputs

    qkv = torch.randn((B, N, 3 * C), generator=gen).to(dev, torch.bfloat16)
    qkv32 = torch.randn((B, N, 3 * C), generator=gen).to(dev)
    pol = torch.zeros((B, N))
    pol[:, 0] = 1.0
    for b in range(B):
        pol[b, 1 + torch.randperm(N - 1, generator=gen)[:81]] = 1.0
    pol = pol.to(dev)
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
    return {name: core_record(name, q, p, n, H) for name, q, p, n in cases}


def core_record(name: str, q: torch.Tensor, p, n: int, heads: int) -> dict:
    """One K4 (``name`` starts "fused_attention_core[") or K5
    ("fused_attention_core_padded[") launch on qkv ``q``, policy ``p``
    (None: all ones) and ``n`` real tokens against its plain versions;
    returns the partial record.

    The map is normalized after a k-th largest discard, where a one-ulp
    difference in the raw map can move an entry across the threshold.
    Each launch is held two ways: (a) against the plain
    normalize_attention_map (exact) of K3's raw map on the same qkv and
    policy (K4/K5 run K3's device code, so the raw map is the same): the
    kept entries identical, the map within 1e-6, K5's pads exactly 0;
    (b) against core_plain / core_padded_plain: out within 1e-5 (fp32) or
    one bf16 ulp of max|out| (``bf16_ulp``; bf16: probs @ v sums its fp32
    products in another order, then rounds), the entries whose kept state
    differs counted (expected 0), the map within 1e-6 on every sample whose
    kept entries agree. The normalize's cluster, its select's route above
    256 tokens (``stats.select_route``) and its two launches' device times
    are printed."""
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.kernels import stats
    from protopformer_tpu_torch.ops.rollout import normalize_attention_map

    lib = _build.library()
    bq, np_, c3 = q.shape
    c = c3 // 3
    stats.select_route(n, "core")  # zeroes the route record
    if "padded" in name:
        kernel = lambda: ac.fused_attention_core_padded(q, p, heads, n)
        plain = lambda: ac.core_padded_plain(q, p, heads, n)
    else:
        kernel = lambda: ac.fused_attention_core(q, p, heads)
        plain = lambda: ac.core_plain(q, p, heads)
    out, fmap = kernel()
    p_out, p_map = plain()
    pol = torch.ones((bq, np_), device=q.device) if p is None else p
    attention = lambda: ac.fused_attention_mean_padded(q, pol, heads, n)
    _, raw = attention()
    route = stats.select_route(n, "core") if n > 256 else None
    want = normalize_attention_map(raw[:, :n, :n], DISCARD, 0.2, True)
    torch.cuda.synchronize()
    same_kept = torch.equal(_kept(fmap[:, :n, :n]), _kept(want))
    pads = float(fmap[:, n:].abs().sum() + fmap[:, :, n:].abs().sum())
    kept_diff = _kept(fmap) != _kept(p_map)
    agree = ~kept_diff.flatten(1).any(dim=1)
    fp32 = q.dtype == torch.float32
    out_tol = 1e-5 if fp32 else bf16_ulp(p_out)
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
    phases = phase_ms(kernel, attention)
    # the normalize's bound: the real block's round trip (read once,
    # written once)
    phases["normalize_bound_ms"] = bound(2.0 * bq * n * n * 4)[0]
    log(f"{name}: normalize launch {bq} clusters, {json.dumps(cluster)}; "
        f"device ms per call by phase {json.dumps(phases)}; select route "
        f"of the first call {json.dumps(route)}")
    require(cluster["ctas_per_sample"] > 1
            and cluster["resident_clusters"] > 0,
            f"{name}: the normalize is not a multi-CTA cluster launch")
    require(phases["normalize"] > 0, f"{name}: no time left for the normalize")
    el = q.element_size()
    nbytes = (bq * np_ * c3 * el + bq * np_ * c * el
              + bq * np_ * np_ * 4 + (0 if p is None else bq * np_ * 4))
    peak = FP32_FLOPS if fp32 else BF16_FLOPS
    return dict(
        kernel=name.split("[")[0],
        source="protopformer_tpu_torch/csrc/attention_core.cu",
        replaces=("protopformer_tpu/kernels/attention_core.py:126"
                  if "padded" in name else
                  "protopformer_tpu/kernels/attention_core.py:43"),
        max_abs_err=max(v for v in errs.values() if v is not None),
        ms=phases["total"],
        plain_ms=time_ms(plain),
        # the work, not the algorithm: the products over all NP rows
        # and columns; over the real block one comparison per entry for
        # the select and one operation for the blend. The bytes term
        # (qkv, policy read once; out, the map written once) is as before
        bound=bound(nbytes, (4.0 * bq * np_ * np_ * c, peak),
                    (2.0 * bq * n * n, FP32_FLOPS)),
    )


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
    size = engine._img_size
    chunk = torch.zeros((engine.batch_size, size, size, 3), dtype=torch.uint8,
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
    # device activity only; "Command Buffer Full" marks a host stall, and a
    # user annotation (the optimizer's step range) spans kernels, not work
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full"
                   and not getattr(e, "is_user_annotation", False))
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


def preset_config(preset: str, **overrides):
    """``backbone_preset`` of ``preset``; "name@size" is the preset ``name``
    at ``img_size`` size (DeiT-Tiny/16 at 448 px: 785 tokens)."""
    from protopformer_tpu_torch.core.config import backbone_preset

    name, _, size = preset.partition("@")
    if size:
        overrides["img_size"] = int(size)
    return backbone_preset(name, **overrides)


def backbone_from(state_dict, backbone_cfg, dtype, device):
    """The PPNet state dict's ``features.*`` in a DeiTBackbone."""
    from protopformer_tpu_torch.models import DeiTBackbone

    model = DeiTBackbone(backbone_cfg, dtype)
    model.load_state_dict({k[len("features."):]: v
                           for k, v in state_dict.items()
                           if k.startswith("features.")}, strict=True)
    return model.to(device).eval()


def thresh(dev: torch.device, state_dict, rng: np.random.Generator,
           preset: str = "deit_tiny_patch16_224", tag: str = "thresh",
           hold_bf16_selection: bool = True,
           hold_fp32_selection: bool = True) -> tuple:
    """masked_forward_thresh of ``preset`` at full depth and B=160, bf16
    exact and fp32, each with the launch counters (K4 on blocks 0-10, K3 on
    block 11, per forward), then on the first 2 images against the CPU:
    fp32 matches the CPU's fp32 (cls_token_attn within 1e-5, x within
    1e-4); against the CPU's bf16 and fp32 forwards, bf16 exact keeps x
    within serving's bf16 bound (rtol 2e-2 plus 2e-2 * max|ref|) and
    cls_token_attn within serving's selection contract against the fp32
    forward where ``hold_fp32_selection``, and against the bf16 one where
    ``hold_bf16_selection``. Else the bf16-against-bf16 reading is
    recorded beside the CPU's own bf16 against its fp32 and
    ``bf16_witness``'s readings over all B images.
    Returns ({path: {"launches": ...}}, {path: the arguments of its first
    K4 call}), the paths named ``tag``_bf16_exact and ``tag``_fp32."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.core.config import PPNetConfig
    from protopformer_tpu_torch.models import layers
    from protopformer_tpu_torch.serving import no_tf32

    reserve = PPNetConfig().reserve_layer_nums
    backbone = preset_config(preset)
    P, size, width = backbone.num_patches, backbone.img_size, backbone.embed_dim
    results, k4_args = {}, {}

    def forward(model, x, token_attn):
        with torch.inference_mode():
            return model.masked_forward_thresh(*model.embed_all(x), token_attn,
                                               reserve)

    x = torch.from_numpy(rng.normal(size=(B, size, size, 3)).astype(
        np.float32))
    token_attn = torch.from_numpy(
        rng.uniform(0, 2.0 / P, size=(B, P)).astype(np.float32))
    paths = ((f"{tag}_bf16_exact", backbone, torch.bfloat16),
             (f"{tag}_fp32", backbone, torch.float32))
    # the CPU runs the kernels' plain versions
    cpu = {path: forward(backbone_from(state_dict, bk, dtype, "cpu"), x[:2],
                         token_attn[:2])
           for path, bk, dtype in paths}
    x, token_attn = x.to(dev), token_attn.to(dev)
    card, card_attn = {}, {}
    for path, bk, dtype in paths:
        model = backbone_from(state_dict, bk, dtype, dev)
        kernels.reset_launch_counts()
        # fp32 as ServingEngine runs it (ROADMAP F1); bf16 as a caller would
        with no_tf32() if dtype == torch.float32 else \
                contextlib.nullcontext(), \
                first_call(layers, "fused_attention_core") as k4:
            out, attn = forward(model, x, token_attn)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"{path}: launches {json.dumps(launches)}")
        require(launches == THRESH_LAUNCHES,
                f"{path}: expected launches {THRESH_LAUNCHES}")
        k4_args[path] = k4[0]
        require(out.shape == (B, 1 + P, width) and attn.shape == (B, P)
                and bool(torch.isfinite(out.float()).all())
                and bool(torch.isfinite(attn).all())
                and bool((attn >= 0).all()),
                f"{path}: wrong shape or non-finite output")
        if dtype == torch.bfloat16:
            prof = profile_chunk(lambda: forward(model, x, token_attn))
            log(f"{path}: profile {json.dumps(prof)}")
        card[path] = (out[:2].float().cpu(), attn[:2].cpu())
        card_attn[path] = attn.float().cpu()
        results[path] = {"launches": launches}
        del model

    got_x, got_attn = card[f"{tag}_fp32"]
    ref_x, ref_attn = cpu[f"{tag}_fp32"]
    errs = {"cls_token_attn": max_err(got_attn, ref_attn),
            "x": max_err(got_x, ref_x)}
    log(f"{tag} fp32 card vs cpu: max abs err {json.dumps(errs)} "
        "(tolerance cls_token_attn 1e-5, x 1e-4)")
    require(errs["cls_token_attn"] <= 1e-5 and errs["x"] <= 1e-4,
            f"{tag} fp32 card vs CPU: outside tolerance")

    def bf16_bound(what: str, got: torch.Tensor, ref: torch.Tensor) -> float:
        """Serving's bf16 value bound: rtol 2e-2 plus 2e-2 * max|ref|."""
        atol = 2e-2 * float(ref.abs().max())
        excess = float(((got - ref).abs() - (atol + 2e-2 * ref.abs())).max())
        log(f"{tag} bf16 exact {what}: max abs err {max_err(got, ref)!r}, "
            f"largest excess over the bound {excess!r} (bound rtol 2e-2, "
            f"atol {atol!r})")
        return excess

    # bf16 exact against the CPU's bf16 forward (the same route in the same
    # dtype) and its fp32 forward: x by the value bound; cls_token_attn, a
    # ranking score, by serving's selection contract, its value error
    # recorded (the hard discard flips entries near the threshold wherever
    # the raw maps differ by an ulp, whichever the reference's dtype)
    got_x, got_attn = card[f"{tag}_bf16_exact"]
    cpu_bf16 = tuple(t.float() for t in cpu[f"{tag}_bf16_exact"])
    for ref, (cpu_x, cpu_attn) in (("cpu bf16", cpu_bf16),
                                   ("cpu fp32", (ref_x, ref_attn))):
        require(bf16_bound(f"x, card vs {ref}", got_x, cpu_x) <= 0,
                f"{tag} bf16 exact x: outside bound of the {ref} forward")
        bf16_bound(f"cls_token_attn, card vs {ref} (recorded)", got_attn,
                   cpu_attn)
        overlap, worst_drop = selection(got_attn.numpy(), cpu_attn.numpy())
        log(f"{tag} bf16 exact vs {ref}: top-81 overlap {overlap}, lowest "
            f"rank dropped {worst_drop}")
        require((ref == "cpu bf16" and not hold_bf16_selection)
                or (ref == "cpu fp32" and not hold_fp32_selection)
                or (min(overlap) >= 74
                    and all(r is None or r >= 64 for r in worst_drop)),
                f"{tag} bf16 exact selection against the {ref} forward: "
                "outside contract")
    if not hold_bf16_selection:
        overlap, worst_drop = selection(cpu_bf16[1].numpy(), ref_attn.numpy())
        log(f"{tag} cpu bf16 exact vs cpu fp32 (recorded): top-81 overlap "
            f"{overlap}, lowest rank dropped {worst_drop}")
        bf16_witness(dev, state_dict, backbone, x, token_attn, card_attn,
                     cpu_bf16[1], tag, forward)
    return results, k4_args


def bf16_witness(dev, state_dict, backbone, x, token_attn, card_attn,
                 cpu_bf16_attn, tag: str, forward) -> None:
    """Records (holds nothing) how far bf16 exact's selection moves, over
    all B images of ``thresh``: the card's kernels and the kernels' plain
    versions run on the card (same roundings, other summation orders),
    each against the card's fp32 kernel forward (held to the CPU's fp32
    above) and against each other, and the plain versions on the card
    against the CPU's bf16 on its 2 images."""
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.models import layers

    def summary(attn, ref):
        overlap, worst = selection(attn.numpy(), ref.numpy())
        drops = [r for r in worst if r is not None]
        return {"images": len(overlap), "min_overlap": min(overlap),
                "lowest_rank_dropped": min(drops, default=None),
                "images_dropping_below_64": sum(r < 64 for r in drops)}

    model = backbone_from(state_dict, backbone, torch.bfloat16, dev)
    saved = layers.fused_attention_core, layers.fused_attention_mean_padded
    layers.fused_attention_core = (
        lambda qkv, pol, heads, ratio, identity_weight:
        ac.core_plain(qkv, pol, heads, ratio, identity_weight))
    layers.fused_attention_mean_padded = ac.mean_padded_plain
    try:
        _, plain = forward(model, x, token_attn)
    finally:
        layers.fused_attention_core, layers.fused_attention_mean_padded = saved
    plain = plain.float().cpu()
    del model
    kern, fp32 = card_attn[f"{tag}_bf16_exact"], card_attn[f"{tag}_fp32"]
    readings = {"kernels_vs_card_fp32": summary(kern, fp32),
                "plain_vs_card_fp32": summary(plain, fp32),
                "kernels_vs_plain": summary(kern, plain),
                "plain_vs_cpu_bf16": summary(plain[:2], cpu_bf16_attn)}
    log(f"{tag} bf16 exact selection witness (recorded): "
        f"{json.dumps(readings)}")


# --- phase 4c: the kernel bench ----------------------------------------------------

def bench(dev: torch.device, tokens: int = N, path: str = "bench") -> dict:
    """cli.bench_kernels.run on the card at ``tokens``; K4 and K5 must have
    launched."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.cli import bench_kernels

    kernels.reset_launch_counts()
    res = bench_kernels.run(dev, tokens=tokens)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"bench_kernels: {json.dumps(res)}; launches {json.dumps(launches)}")
    require(launches["fused_attention_core_padded"] > 0
            and launches["fused_attention_core"] > 0,
            "bench_kernels: K4 or K5 never launched")
    return {path: {"launches": launches}}


# --- phase 4d: CaiT serving -------------------------------------------------------

def cait(dev: torch.device, rng: np.random.Generator) -> dict:
    """CaiT-XXS-24 PPNet serving in three modes, each launching no kernel,
    then the card against the CPU on 2 images. Returns {mode: {"launches",
    "img_per_sec"}}."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.serving import ServingEngine

    ppnet = PPNetConfig(reserve_layers=(1,), reserve_token_nums=(81,))
    modes = {
        "cait_bf16_speed": (backbone_preset("cait_xxs24_224",
                                            rollout_exact_discard=False),
                            torch.bfloat16),
        "cait_bf16_exact": (backbone_preset("cait_xxs24_224"), torch.bfloat16),
        "cait_fp32_parity": (backbone_preset("cait_xxs24_224"), torch.float32),
    }
    state_dict = construct_ppnet(
        modes["cait_fp32_parity"][0], ppnet, torch.float32,
        generator=torch.Generator().manual_seed(3)).state_dict()
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
        log(f"serve {mode}: launches {json.dumps(launches)}")
        require(set(launches.values()) == {0},
                f"serve {mode}: a CaiT forward launched a kernel")
        for n, res in zip(REQUESTS, answers):
            require(res.logits.shape == (n, ppnet.num_classes)
                    and res.cls_token_attn.shape == (n, 196)
                    and bool(np.isfinite(res.logits).all()
                             and np.isfinite(res.cls_token_attn).all()),
                    f"serve {mode}: wrong shape or non-finite output for "
                    f"{n} images")
        probe = engine.throughput_probe(n_images=CAIT_PROBE_IMAGES, reps=2)
        log(f"serve {mode}: throughput_probe {json.dumps(probe)}")
        # one forward: a CaiT chunk makes ~10,000 launches, and reading
        # their trace takes seconds per forward
        t0 = time.perf_counter()
        log(f"serve {mode}: profile "
            f"{json.dumps(profile_forward(engine, reps=1))} "
            f"({time.perf_counter() - t0:.1f} s)")
        results[mode] = {"launches": launches,
                         "img_per_sec": probe["img_per_sec"]}
        del engine

    imgs = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)

    def run(bk, dtype, device):
        return ServingEngine(bk, ppnet, state_dict, batch_size=2,
                             compute_dtype=dtype, with_attn=True,
                             device=device)(imgs)

    backbone, _ = modes["cait_fp32_parity"]
    cpu = run(backbone, torch.float32, "cpu")
    card = run(backbone, torch.float32, dev)
    errs = {"cls_token_attn": float(np.abs(card.cls_token_attn
                                           - cpu.cls_token_attn).max()),
            "logits": float(np.abs(card.logits - cpu.logits).max())}
    same = [a == b for a, b in zip(top81(card.cls_token_attn),
                                   top81(cpu.cls_token_attn))]
    log(f"cait card vs cpu fp32: max abs err {json.dumps(errs)} (tolerance "
        f"cls_token_attn 1e-5, logits 1e-4); same top-81 set {same}")
    require(errs["cls_token_attn"] <= 1e-5 and errs["logits"] <= 1e-4
            and all(same), "cait fp32 card vs CPU: outside contract")
    atol = 2e-2 * float(np.abs(cpu.logits).max())
    for mode in ("cait_bf16_speed", "cait_bf16_exact"):
        bf16 = run(modes[mode][0], torch.bfloat16, dev)
        overlap, worst_drop = selection(bf16.cls_token_attn,
                                        cpu.cls_token_attn)
        excess = np.abs(bf16.logits - cpu.logits) - (
            atol + 2e-2 * np.abs(cpu.logits))
        log(f"card {mode} vs cpu fp32: top-81 overlap {overlap}, lowest "
            f"fp32 rank dropped {worst_drop}; logits max abs err "
            f"{float(np.abs(bf16.logits - cpu.logits).max())!r} (bound rtol "
            f"2e-2, atol {atol!r})")
        require(min(overlap) >= 76, f"{mode} selection: overlap below 76/81")
        require(all(r is None or r >= 60 for r in worst_drop),
                f"{mode} selection: dropped a token of fp32 rank below 60")
        require(bool((excess <= 0).all()), f"{mode} logits: outside bound")
    return results


# --- phase 4e: training -------------------------------------------------------

# launches of one DeiT train step (any compute dtype): K2 on the detached
# fp32 map of each pre-prune block, no attention kernel
TRAIN_LAUNCHES = {"fused_attention_block_stats": 0, "fused_map_stats": 11,
                  "fused_attention_mean_padded": 0, "fused_attention_core": 0,
                  "fused_attention_core_padded": 0}
# launches of evaluate over two bf16 batches: the serving forward's
EVAL_LAUNCHES = expected_launches("bf16_exact", 2)
CAIT_TRAIN_B = 16
RAGGED_VALID = 77  # valid images of the second eval batch


def train_setup(backbone, ppnet, dtype, device, seed: int):
    """A seeded PPNet's train state and train step at the CUB preset's
    optimizer (``OptimConfig``'s defaults are scripts/train_cub.sh's)."""
    from protopformer_tpu_torch import train
    from protopformer_tpu_torch.core.config import OptimConfig
    from protopformer_tpu_torch.models import construct_ppnet

    optim = OptimConfig()
    model = construct_ppnet(backbone, ppnet, dtype,
                            generator=torch.Generator().manual_seed(seed))
    state = train.create_train_state(
        model, train.make_optimizer(optim, model, TRAIN_STEPS_PER_EPOCH),
        device=device)
    return state, train.make_train_step(model, ppnet, optim, device=device)


def train_batch(dev: torch.device, gen: torch.Generator, n: int,
                classes: int = 200) -> dict:
    """Seeded [0, 1] NHWC images and integer labels on ``dev``."""
    return {"image": torch.rand((n, 224, 224, 3), generator=gen).to(dev),
            "label": torch.randint(0, classes, (n,), generator=gen).to(dev)}


def train_phase(dev: torch.device) -> dict:
    """Phase 4e (see the module docstring). Returns {path: {"launches",
    "ms_per_step", "img_per_sec"}} for the two train modes and the eval."""
    from protopformer_tpu_torch import kernels, train
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset

    ppnet = PPNetConfig()  # the CUB preset's head, PPC on
    backbone = backbone_preset("deit_tiny_patch16_224")  # drop path 0.1
    gen = torch.Generator().manual_seed(4)
    batch = train_batch(dev, gen, TRAIN_B)
    results = {}
    for path, dtype in (("train_bf16", torch.bfloat16),
                        ("train_fp32", torch.float32)):
        state, step = train_setup(backbone, ppnet, dtype, dev, seed=5)
        step_gen = torch.Generator(dev).manual_seed(0)

        def run():
            return step(state, batch, step_gen, 1.0)[1]

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        metrics = run()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"{path}: launches of one step {json.dumps(launches)}")
        require(launches == TRAIN_LAUNCHES,
                f"{path}: expected launches {TRAIN_LAUNCHES}")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        losses = [run()["loss"] for _ in range(10)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 10 * 1e3
        losses = torch.stack(losses).tolist()
        require(all(math.isfinite(v) for v in losses),
                f"{path}: non-finite loss {losses}")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"{path}: B={TRAIN_B} {ms:.2f} ms/step, "
            f"{TRAIN_B / ms * 1e3:.1f} img/s over 10 steps; peak device "
            f"memory {peak:.2f} GiB; metrics of the counted step "
            f"{json.dumps({k: float(v) for k, v in metrics.items()})}")
        t0 = time.perf_counter()
        log(f"{path}: profile {json.dumps(profile_chunk(run, reps=2))} "
            f"({time.perf_counter() - t0:.1f} s)")
        results[path] = {"launches": launches, "ms_per_step": ms,
                         "img_per_sec": TRAIN_B / ms * 1e3}
        if dtype == torch.bfloat16:
            trained = state.model
        del state, step

    # 20 steps on one fixed batch from the first epoch at the preset's full
    # LRs (after its 5 warm-up epochs)
    state, step = train_setup(backbone, ppnet, torch.bfloat16, dev, seed=6)
    state.step = 5 * TRAIN_STEPS_PER_EPOCH
    step_gen = torch.Generator(dev).manual_seed(1)
    losses = torch.stack([step(state, batch, step_gen, 1.0)[1]["loss"]
                          for _ in range(20)]).tolist()
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"train_bf16 fixed batch: loss over 20 steps {json.dumps(losses)}; "
        f"mean of the first 5 {first!r}, of the last 5 {last!r}")
    require(all(math.isfinite(v) for v in losses) and last < first,
            "train_bf16: 20 steps on one batch did not lower the loss")
    del state, step

    train_card_vs_cpu(dev, ppnet)

    # evaluate over two batches, the second ragged
    eval_step = train.make_eval_step(device=dev)
    ragged = train_batch(dev, gen, TRAIN_B)
    ragged["valid"] = (torch.arange(TRAIN_B) < RAGGED_VALID).float().to(dev)
    kernels.reset_launch_counts()
    res = train.evaluate(eval_step, trained, [batch, ragged])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"train_eval: evaluate over {TRAIN_B} + {RAGGED_VALID} images "
        f"{json.dumps(res)}; launches {json.dumps(launches)}")
    require(launches == EVAL_LAUNCHES,
            f"train_eval: expected launches {EVAL_LAUNCHES}")
    require(all(math.isfinite(v) for v in res.values())
            and 0.0 <= res["acc1"] <= res["acc5"] <= 100.0,
            "train_eval: out of range")
    results["train_eval"] = {"launches": launches}

    # CaiT-XXS-24 at its preset (reserve at class-attention block 1)
    cait_pp = PPNetConfig(reserve_layers=(1,), reserve_token_nums=(81,))
    state, step = train_setup(backbone_preset("cait_xxs24_224"), cait_pp,
                              torch.bfloat16, dev, seed=7)
    cait_batch = train_batch(dev, gen, CAIT_TRAIN_B)
    step_gen = torch.Generator(dev).manual_seed(2)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = torch.stack([step(state, cait_batch, step_gen, 1.0)[1]["loss"]
                          for _ in range(2)]).tolist()
    ms = (time.perf_counter() - t0) / 2 * 1e3
    launches = kernels.launch_counts()
    log(f"train_cait_bf16: B={CAIT_TRAIN_B} losses {losses}, {ms:.1f} ms/step "
        f"(2 steps, the first included); launches {json.dumps(launches)}")
    require(all(math.isfinite(v) for v in losses),
            "train_cait_bf16: non-finite loss")
    require(set(launches.values()) == {0},
            "train_cait_bf16: a CaiT train step launched a kernel")
    return results


def train_card_vs_cpu(dev: torch.device, ppnet) -> None:
    """One fp32 train step at B=4 with drop path 0 from the same seeded
    weights on the card (TF32 off) and on the CPU."""
    from protopformer_tpu_torch.core.config import backbone_preset

    backbone = backbone_preset("deit_tiny_patch16_224", drop_path_rate=0.0)
    batch = train_batch(torch.device("cpu"), torch.Generator().manual_seed(8),
                        4)
    runs = []
    for device in ("cpu", dev):
        state, step = train_setup(backbone, ppnet, torch.float32, device,
                                  seed=9)
        metrics = step(state, batch, torch.Generator(device), 1.0)[1]
        runs.append((float(metrics["loss"]), {
            n: (p.detach().cpu(), None if p.grad is None else p.grad.cpu())
            for n, p in state.model.named_parameters()}))
    (cpu_loss, cpu), (card_loss, card) = runs
    # the CPU's AdamW step from the same weights on the card's gradients
    state, _ = train_setup(backbone, ppnet, torch.float32, "cpu", seed=9)
    for name, p in state.model.named_parameters():
        p.grad = None if card[name][1] is None else card[name][1].clone()
    state.apply_gradients()
    replay = {n: p.detach() for n, p in state.model.named_parameters()}
    res = step_contract(cpu, card, replay)
    res["loss"] = abs(card_loss - cpu_loss)
    log(f"train fp32 card vs cpu (B=4): {json.dumps(res)} (tolerance loss "
        "1e-5, gradients 2e-4 * max|g| + 1e-7 each, the card's step 1e-6 "
        "of the CPU's step on the card's gradients)")
    require(res["loss"] <= 1e-5 and res["holds"],
            "train fp32 card vs CPU: outside contract")


def step_contract(cpu: dict, card: dict, replay: dict) -> dict:
    """One train step's {name: (parameter after, gradient)} on the CPU and
    the card, and ``replay`` {name: parameter}, the CPU's optimizer step
    from the same weights on the card's gradients: every gradient within
    2e-4 * max|g| + 1e-7 of the CPU's, and the card's parameters within
    1e-6 of ``replay``. The parameters' difference from the CPU's own
    step is recorded, not bounded: AdamW's first step is lr * g / (|g| +
    eps), so an entry whose gradient is within a few eps of 0 (a key
    bias's is 0 in exact arithmetic: a constant added to a row of logits
    leaves its softmax unchanged) turns a gradient difference inside the
    contract into a step difference of up to lr. Returns the readings and
    "holds"."""
    grad_excess, step_err, param_err = -math.inf, 0.0, 0.0
    missing, over, over_grad = [], 0, 0.0
    for name, (p, g) in cpu.items():
        q, h = card[name]
        if (g is None) != (h is None):
            missing.append(name)
            continue
        step_err = max(step_err, max_err(q, replay[name]))
        diff = (q - p).abs()
        param_err = max(param_err, float(diff.max()))
        if g is not None:
            tol = 2e-4 * max(float(g.abs().max()), 1e-8) + 1e-7
            grad_excess = max(grad_excess, max_err(h, g) - tol)
            far = diff > 1e-6
            over += int(far.sum())
            if bool(far.any()):
                over_grad = max(over_grad, float(g.abs()[far].max()))
    return {"grad_excess_over_tolerance": grad_excess,
            "step_vs_cpu_step_on_card_grads": step_err,
            "params_vs_cpu": param_err,
            "params_vs_cpu_entries_over_1e-6": over,
            "max_abs_cpu_grad_of_those_entries": over_grad,
            "missing_grads": missing,
            "holds": not missing and grad_excess <= 0.0 and step_err <= 1e-6}


# --- phase 4f: DeiT-S/B at width, push_forward, the kernel-off structure ----------

SB_PROBE_IMAGES = {"deit_small_patch16_224": PROBE_IMAGES,
                   "deit_base_patch16_224": 160 * 10,
                   "deit_base_patch16_384": 160 * 4,
                   "deit_tiny_patch2_32": PROBE_IMAGES,
                   "deit_tiny_patch16_224@448": 160 * 4,
                   "deit_tiny_patch16_224@512": 160 * 4}
# the path and record tag of each preset served at width
WIDTH_TAGS = {"deit_small_patch16_224": "deit_s",
              "deit_base_patch16_224": "deit_b",
              "deit_base_patch16_384": "deit_b384",
              "deit_tiny_patch2_32": "deit_t_p2",
              "deit_tiny_patch16_224@448": "deit_t448",
              "deit_tiny_patch16_224@512": "deit_t512"}
OFF_PROBE_IMAGES = PROBE_IMAGES
UNPRUNED_B = 32
NO_LAUNCHES = {name: 0 for name in expected_launches("fp32_parity", 0)}


@contextlib.contextmanager
def first_call(module, name: str):
    """Record the arguments of the first call of ``module.name`` (called
    through) in the list it yields."""
    fn = getattr(module, name)
    seen = []

    def wrapped(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def log_cluster(what: str, size: int, resident: int) -> None:
    """Prints a cluster launch's CTAs per sample and how many of its
    clusters the card holds at once; fails unless some fit."""
    log(f"{what}: " + json.dumps({"ctas_per_sample": size,
                                  "resident_clusters": resident}))
    require(resident > 0, f"{what}: no cluster fits the card")


def log_resident(what: str, ctas: int, smem: int) -> None:
    """Prints a plain launch's CTAs an SM holds at once and its shared
    memory; fails unless one fits."""
    log(f"{what}: " + json.dumps({"resident_ctas_per_sm": ctas,
                                  "smem_bytes": smem}))
    require(ctas > 0, f"{what}: no CTA fits an SM")


def select_reading(what: str, fmap: torch.Tensor, exact: bool,
                   kthvalue: bool = False) -> None:
    """Prints the map select's launch (K2's kernel: K2 itself, or K1's
    second launch above 256 tokens, whose only difference is the cap at
    1.0) on a model's stored (B, N, N) map: t bit-equal to the plain
    version, its ms beside its bound (the map read once, t and s written
    once) and its cluster; on fp32 keys also the select's route
    (``stats.select_route``), required to be the compact lists' above
    512 tokens. With ``kthvalue``, also the time of a two-call
    reference on the same map: ``torch.kthvalue`` of the flattened map,
    then the masked row sum (a reference, not a yardstick: kthvalue
    orders values, not the select's keys)."""
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import stats

    b, n, _ = fmap.shape
    keep = n * n - int(n * n * DISCARD)
    lib = _build.library()
    stats.select_route(n)  # zeroes the route record
    t, s = stats.fused_map_stats(fmap, DISCARD, exact_discard=exact)
    p_t, p_s = stats.map_stats_plain(fmap, keep, prefix16=not exact)
    torch.cuda.synchronize()
    route = stats.select_route(n)
    require(torch.equal(t.float(), p_t) and max_err(s, p_s) <= 1e-6,
            f"{what}: t or s differs from the plain version")
    nbytes = b * n * n * fmap.element_size() + b * 4 + b * n * 4
    bound_ms, bound_by = bound(nbytes, (2.0 * b * n * n, FP32_FLOPS))
    reading = {
        "ms": time_ms(lambda: stats.fused_map_stats(fmap, DISCARD, exact)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "ctas_per_sample": lib.ppf_map_stats_cluster_size(n),
        "resident_clusters": lib.ppf_map_stats_active_clusters(
            n, int(fmap.dtype == torch.bfloat16))}
    if kthvalue:
        flat = fmap.float().reshape(b, -1)
        kth = n * n - keep + 1  # the keep-th largest is the kth smallest

        def two_calls():
            tk = flat.kthvalue(kth, dim=1).values
            return torch.where(fmap >= tk[:, None, None], fmap, 0).sum(-1)

        reading["kthvalue_and_row_sum_ms"] = time_ms(two_calls)
    log(f"{what} (the select alone, the model's map): "
        f"{json.dumps(reading)}")
    require(reading["resident_clusters"] > 0, f"{what}: no cluster fits")
    if exact:
        # fp32 keys: the last two passes over the compact key lists where
        # they fit; above 512 tokens the models' maps must take that route
        log(f"{what}: select route {json.dumps(route)} (band_passes: "
            f"samples whose lists overflowed)")
        require(n <= 512 or route["band_passes"] == 0,
                f"{what}: the key lists overflowed on the model's map")


def k1_record(qkv: torch.Tensor, heads: int, exact: bool) -> dict:
    """K1 against its plain version on a model's own qkv (``k1_contract``),
    timed and bounded; returns the partial record."""
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.kernels import stats
    from protopformer_tpu_torch.ops.rollout import masked_map_stats

    b, n, c3 = qkv.shape
    c = c3 // 3
    lib = _build.library()
    # up to 256 tokens K1's own cluster launch, above that K2's select after
    # the heads kernel (log_resident)
    log_cluster(f"K1 launch at N={n}, hd={c // heads}",
                lib.ppf_attention_block_stats_cluster_size(n),
                lib.ppf_attention_block_stats_active_clusters(n, c // heads))
    if n > 256:
        log_resident(f"K1 heads kernel at N={n}, hd={c // heads}",
                     lib.ppf_attention_block_stats_long_resident_ctas(
                         n, c // heads),
                     lib.ppf_attention_block_stats_smem_bytes(n, c // heads))
    keep = n * n - int(n * n * DISCARD)
    out, fmap, t, s = ac.fused_attention_block_stats(qkv, heads, DISCARD, exact)
    p_out, p_map, p_t, _ = ac.block_stats_plain(qkv, heads, keep, exact)
    own_t, _ = masked_map_stats(fmap, DISCARD, exact_discard=exact)
    own_s = stats.masked_row_sums(fmap.float(), t.float())
    torch.cuda.synchronize()
    res = k1_contract(out, fmap, t, s, p_out, p_map, p_t, own_t, own_s,
                      heads)
    mode = "exact" if exact else "speed"
    if n > 256:
        select_reading(f"K1's select at N={n}, {mode}", fmap, exact)
    log(f"K1 {mode} H={heads} C={c} (model qkv): {json.dumps(res)}")
    require(res["t_equal_own"],
            f"K1 {mode} H={heads}: t differs from masked_map_stats on its map")
    require(res["holds"] and res["t_only_where_map_differs"],
            f"K1 {mode} H={heads}: outside its contract with the plain version")
    nbytes = (b * n * c3 * 2 + b * n * c * 2 + b * n * n * (4 if exact else 2)
              + b * 4 + b * n * 4)
    return dict(
        kernel="fused_attention_block_stats",
        source="protopformer_tpu_torch/csrc/attention_block_stats.cu",
        replaces="protopformer_tpu/kernels/attention_core.py:474",
        max_abs_err=max(res["got"][k] for k in ("s", "map", "out")),
        ms=time_ms(lambda: ac.fused_attention_block_stats(qkv, heads,
                                                          DISCARD, exact)),
        plain_ms=time_ms(lambda: ac.block_stats_plain(qkv, heads, keep, exact)),
        bound=bound(nbytes, (4.0 * b * n * n * c, BF16_FLOPS)),
    )


def k3_record(qkv: torch.Tensor, pol: torch.Tensor, heads: int) -> dict:
    """K3 against its plain version on a model's own qkv and policy (out
    within 1e-5 in fp32 or 1e-2 in bf16, map within 1e-6), timed and
    bounded; returns the partial record."""
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import attention_core as ac

    b, n, c3 = qkv.shape
    c = c3 // 3
    if n > 256 and qkv.dtype == torch.float32:
        lib = _build.library()
        log_resident(f"K3 fp32 long kernel at N={n}, hd={c // heads}",
                     lib.ppf_attention_mean_f32_resident_blocks(n, c // heads),
                     lib.ppf_attention_mean_smem_bytes(n, c // heads, 0))
    out, fmap = ac.fused_attention_mean_padded(qkv, pol, heads, real_n=n)
    p_out, p_map = ac.mean_padded_plain(qkv, pol, heads, real_n=n)
    torch.cuda.synchronize()
    fp32 = qkv.dtype == torch.float32
    tol = 1e-5 if fp32 else 1e-2
    errs = {"out": max_err(out, p_out), "map": max_err(fmap, p_map)}
    log(f"K3 {qkv.dtype} N={n} H={heads} C={c} (model qkv): max abs err "
        f"{json.dumps(errs)} (tolerance out {tol}, map 1e-6)")
    require(errs["out"] <= tol and errs["map"] <= 1e-6,
            f"K3 N={n} H={heads}: outside tolerance")
    el = qkv.element_size()
    nbytes = b * n * c3 * el + b * n * 4 + b * n * c * el + b * n * n * 4
    return dict(
        kernel="fused_attention_mean_padded",
        source="protopformer_tpu_torch/csrc/attention_mean.cu",
        replaces="protopformer_tpu/kernels/attention_core.py:231",
        max_abs_err=max(errs.values()),
        ms=time_ms(lambda: ac.fused_attention_mean_padded(qkv, pol, heads, n)),
        plain_ms=time_ms(lambda: ac.mean_padded_plain(qkv, pol, heads, n)),
        bound=bound(nbytes, (4.0 * b * n * n * c,
                             FP32_FLOPS if fp32 else BF16_FLOPS)),
    )


def k2_record(fmap: torch.Tensor, exact: bool) -> dict:
    """K2 against ``map_stats_plain`` on a model's own stored map (fp32
    exact, or bf16 with the 16-bit prefix select): t bit-equal, s within
    1e-6; timed and bounded; returns the partial record."""
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import stats

    b, n, _ = fmap.shape
    keep = n * n - int(n * n * DISCARD)
    lib = _build.library()
    bf16 = int(fmap.dtype == torch.bfloat16)
    log_cluster(f"K2 launch at N={n}, {fmap.dtype}",
                lib.ppf_map_stats_cluster_size(n),
                lib.ppf_map_stats_active_clusters(n, bf16))
    t, s = stats.fused_map_stats(fmap, DISCARD, exact_discard=exact)
    p_t, p_s = stats.map_stats_plain(fmap, keep, prefix16=not exact)
    torch.cuda.synchronize()
    err = max_err(s, p_s)
    log(f"K2 {fmap.dtype} map B={b} N={n} (model map): t bit-equal "
        f"{torch.equal(t.float(), p_t)}; max abs err {json.dumps({'s': err})} "
        "(tolerance s 1e-6)")
    require(torch.equal(t.float(), p_t), "K2: t differs from the plain version")
    require(err <= 1e-6, "K2: outside tolerance")
    if n > 256:
        select_reading(f"K2 at N={n}, {fmap.dtype}", fmap, exact,
                       kthvalue=True)
    nbytes = b * n * n * fmap.element_size() + b * 4 + b * n * 4
    return dict(
        kernel="fused_map_stats",
        source="protopformer_tpu_torch/csrc/map_stats.cu",
        replaces="protopformer_tpu/kernels/stats.py:33",
        max_abs_err=err,
        ms=time_ms(lambda: stats.fused_map_stats(fmap, DISCARD, exact)),
        plain_ms=time_ms(lambda: stats.map_stats_plain(fmap, keep, not exact)),
        bound=bound(nbytes, (2.0 * b * n * n, FP32_FLOPS)),
    )


def serve_width(dev: torch.device, preset: str, modes: tuple,
                rng: np.random.Generator, hold_vs_fp32: bool) -> tuple:
    """A DeiT PPNet of ``preset`` (WIDTH_TAGS; ``preset_config``'s names)
    at the CUB preset (seeded
    weights) served at B=160 in ``modes``: per mode one chunk with the
    launch counters, a throughput probe and a profile of one chunk; the
    kernels against their plain versions on the model's own qkv and maps
    (K3 in bf16 at N=82 on the 224 presets only: the gathered block has the
    same shape at every image size); the card against the
    CPU on 2 images: fp32 logits within 1e-4 and the same top-81; each bf16
    mode by phase 5's contract against the CPU's fp32 forward where
    ``hold_vs_fp32``, else that reading recorded; beside it the readings
    of the card against the CPU's forward in the same mode and of the
    CPU's own bf16 against its fp32 (recorded: ranks among bf16 scores
    move with one ulp). Returns ({path: {"launches", "img_per_sec"}},
    {record name: partial record}, state dict, images)."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.core.config import PPNetConfig
    from protopformer_tpu_torch.models import construct_ppnet, deit, layers
    from protopformer_tpu_torch.serving import ServingEngine

    tag = WIDTH_TAGS[preset]
    ppnet = PPNetConfig()
    configs = {
        "bf16_speed": (preset_config(preset, rollout_exact_discard=False),
                       torch.bfloat16),
        "bf16_exact": (preset_config(preset), torch.bfloat16),
        "fp32_parity": (preset_config(preset), torch.float32),
    }
    heads = configs["fp32_parity"][0].num_heads
    size = configs["fp32_parity"][0].img_size
    n = configs["fp32_parity"][0].num_patches + 1
    # the record names of the 224 presets carry no token count
    at = "" if n == N else f",N={n}"
    state_dict = construct_ppnet(
        configs["fp32_parity"][0], ppnet, torch.float32,
        generator=torch.Generator().manual_seed(10)).state_dict()
    chunk = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    results, records = {}, {}
    for mode in modes:
        backbone, dtype = configs[mode]
        engine = ServingEngine(backbone, ppnet, state_dict, batch_size=B,
                               compute_dtype=dtype, with_attn=True,
                               device=dev)
        kernels.reset_launch_counts()
        res = engine(chunk)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = expected_launches(mode, 1)
        log(f"serve {tag} {mode}: launches {json.dumps(launches)}")
        require(launches == want, f"serve {tag} {mode}: expected {want}")
        require(res.logits.shape == (B, ppnet.num_classes)
                and bool(np.isfinite(res.logits).all()
                         and np.isfinite(res.cls_token_attn).all()),
                f"serve {tag} {mode}: wrong shape or non-finite output")
        probe = engine.throughput_probe(n_images=SB_PROBE_IMAGES[preset],
                                        reps=2)
        log(f"serve {tag} {mode}: throughput_probe {json.dumps(probe)}")
        log(f"serve {tag} {mode}: profile "
            f"{json.dumps(profile_forward(engine, reps=1))}")
        results[f"{tag}_{mode}"] = {"launches": launches,
                                    "img_per_sec": probe["img_per_sec"]}
        # the kernels on this model's own operands (not counted)
        dev_chunk = torch.from_numpy(chunk).to(dev)
        with first_call(layers, "fused_attention_block_stats") as k1, \
                first_call(layers, "fused_attention_mean_padded") as k3, \
                first_call(deit, "fused_map_stats") as k2:
            engine._forward(dev_chunk)
        torch.cuda.synchronize()
        if mode.startswith("bf16"):
            exact = mode == "bf16_exact"
            records[f"fused_attention_block_stats[{mode[5:]},H={heads}{at}]"] = (
                k1_record(k1[0][0][0].clone(), heads, exact))
            if mode == "bf16_speed" and size == 224:
                qkv, pol = (a.clone() for a in k3[0][0][:2])
                records[f"fused_attention_mean_padded[bf16,N=82,H={heads}]"] = (
                    k3_record(qkv, pol, heads))
        else:
            qkv, pol = (a.clone() for a in k3[0][0][:2])
            records[f"fused_attention_mean_padded[fp32,N={n},H={heads}]"] = (
                k3_record(qkv, pol, heads))
            records[f"fused_map_stats[fp32,H={heads}{at} map]"] = k2_record(
                k2[0][0][0].clone(), True)
        del engine, k1, k2, k3

    # the card against the CPU on 2 images
    imgs = chunk[:2]

    def run(bk, dtype, device):
        return ServingEngine(bk, ppnet, state_dict, batch_size=2,
                             compute_dtype=dtype, with_attn=True,
                             device=device)(imgs)

    cpu = run(configs["fp32_parity"][0], torch.float32, "cpu")
    card = run(configs["fp32_parity"][0], torch.float32, dev)
    err = float(np.abs(card.logits - cpu.logits).max())
    same = [a == b for a, b in zip(top81(card.cls_token_attn),
                                   top81(cpu.cls_token_attn))]
    log(f"{tag} card vs cpu fp32: logits max abs err {err!r}; same top-81 "
        f"set {same}")
    require(err <= 1e-4 and all(same), f"{tag} fp32 card vs CPU: outside "
            "contract")
    for mode in modes:
        if not mode.startswith("bf16"):
            continue
        card_bf16 = run(configs[mode][0], torch.bfloat16, dev)
        cpu_bf16 = run(configs[mode][0], torch.bfloat16, "cpu")
        for what, got, ref, held in (
                ("card vs cpu fp32", card_bf16, cpu, hold_vs_fp32),
                ("card vs cpu bf16", card_bf16, cpu_bf16, False),
                ("cpu bf16 vs cpu fp32", cpu_bf16, cpu, False)):
            ok = bf16_contract(f"{tag} {mode} {what}", got, ref)
            require(ok or not held, f"{tag} {mode} {what}: outside phase "
                    "5's contract")
    return results, records, state_dict, chunk


def bf16_contract(what: str, got, ref) -> bool:
    """Phase 5's contract of a bf16 forward against a reference forward on
    the same images: at least 74 of the reference's top-81 kept, none of
    reference rank below 64 dropped, logits within rtol 2e-2 plus 2e-2 *
    max|ref logits|. Logs the readings; returns whether it holds."""
    overlap, worst_drop = selection(got.cls_token_attn, ref.cls_token_attn)
    atol = 2e-2 * float(np.abs(ref.logits).max())
    excess = np.abs(got.logits - ref.logits) - (atol + 2e-2 * np.abs(ref.logits))
    ok = (min(overlap) >= 74 and all(r is None or r >= 64 for r in worst_drop)
          and bool((excess <= 0).all()))
    log(f"{what}: top-81 overlap {overlap}, lowest reference rank dropped "
        f"{worst_drop}; logits max abs err "
        f"{float(np.abs(got.logits - ref.logits).max())!r} (bound rtol 2e-2, "
        f"atol {atol!r}); holds {ok}")
    return ok


def push_phase(dev: torch.device, state_dict, chunk: np.ndarray) -> dict:
    """DeiT-S ``push_forward`` through ``ServingEngine.push_forward`` at
    B=160 in bf16 exact: its launches those of one eval forward, its
    cls_token_attn bit-equal to the eval forward's on the same chunk, the
    activations finite on a 9 x 9 grid; in fp32 on 2 images the card within
    1e-4 of the CPU's proto_acts."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.serving import ServingEngine

    ppnet = PPNetConfig()
    backbone = backbone_preset("deit_small_patch16_224")
    engine = ServingEngine(backbone, ppnet, state_dict, batch_size=B,
                           compute_dtype=torch.bfloat16, with_attn=True,
                           device=dev)
    served = engine(chunk)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    push = engine.push_forward(chunk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    want = expected_launches("bf16_exact", 1)
    same = bool(np.array_equal(push.cls_token_attn, served.cls_token_attn))
    log(f"push_forward deit_s bf16_exact B={B}: launches "
        f"{json.dumps(launches)}; cls_token_attn bit-equal to the eval "
        f"forward's {same}; proto_acts {push.proto_acts.shape}; {ms:.1f} ms "
        "(host clock, the copy-in and fetch included)")
    require(launches == want, f"push_forward: expected launches {want}")
    require(same, "push_forward: cls_token_attn differs from the eval forward")
    require(push.proto_acts.shape == (B, ppnet.num_prototypes, 9, 9)
            and bool(np.isfinite(push.proto_acts).all()),
            "push_forward: wrong shape or non-finite proto_acts")
    del engine

    def run(device):
        return ServingEngine(backbone, ppnet, state_dict, batch_size=2,
                             compute_dtype=torch.float32, device=device
                             ).push_forward(chunk[:2])

    cpu, card = run("cpu"), run(dev)
    errs = {"proto_acts": float(np.abs(card.proto_acts - cpu.proto_acts).max()),
            "cls_token_attn": float(np.abs(card.cls_token_attn
                                           - cpu.cls_token_attn).max())}
    log(f"push_forward deit_s fp32 card vs cpu (2 images): max abs err "
        f"{json.dumps(errs)} (tolerance proto_acts 1e-4)")
    require(errs["proto_acts"] <= 1e-4, "push_forward fp32 card vs CPU: "
            "outside tolerance")
    return {"deit_s_push": {"launches": launches}}


def kernel_off_phase(dev: torch.device, state_dict,
                     rng: np.random.Generator) -> tuple:
    """The kernel-off structure on DeiT-Tiny/16@224 (the serving weights),
    B=160, in three cases: bf16 speed with ``stats_kernel`` on (K2 on the
    headloop's bf16 maps, 11 a chunk), fp32 with ``stats_kernel="off"`` and
    ``rollout_discard_sample=4`` (no kernel), fp32 with
    ``rollout_stats_batched="on"`` (no kernel). Each: its launches on one
    chunk, the card's img/s; the fp32 batched case against the kernel-on
    fp32 forward on the same chunk (logits within 1e-4, the same top-81);
    the bf16 case's logits within phase 5's bound of that forward, its
    selection recorded beside the kernel-on bf16 speed forward's (over 160
    images the tail of a bf16 selection reaches lower fp32 ranks than over
    phase 5's 2); K2's bf16 mode against its plain version on the path's
    own map.
    Returns ({path: {"launches", "img_per_sec"}}, {record name: partial
    record})."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import deit
    from protopformer_tpu_torch.serving import ServingEngine

    ppnet = PPNetConfig()
    tiny = "deit_tiny_patch16_224"
    cases = {
        "off_bf16_speed_k2": (backbone_preset(
            tiny, use_pallas="off", stats_kernel="on",
            rollout_exact_discard=False), torch.bfloat16,
            dict(NO_LAUNCHES, fused_map_stats=11)),
        "off_fp32_sample4": (backbone_preset(
            tiny, use_pallas="off", stats_kernel="off",
            rollout_exact_discard=False, rollout_discard_sample=4),
            torch.float32, NO_LAUNCHES),
        "off_fp32_batched": (backbone_preset(
            tiny, use_pallas="off", stats_kernel="off",
            rollout_stats_batched="on"), torch.float32, NO_LAUNCHES),
    }
    chunk = rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
    on = ServingEngine(backbone_preset(tiny), ppnet, state_dict, batch_size=B,
                       compute_dtype=torch.float32, with_attn=True,
                       device=dev)(chunk)
    on_speed = ServingEngine(
        backbone_preset(tiny, rollout_exact_discard=False), ppnet, state_dict,
        batch_size=B, compute_dtype=torch.bfloat16, with_attn=True,
        device=dev)(chunk)
    bf16_contract("kernel-on bf16 speed vs kernel-on fp32 (recorded)",
                  on_speed, on)
    results, records = {}, {}
    for path, (backbone, dtype, want) in cases.items():
        engine = ServingEngine(backbone, ppnet, state_dict, batch_size=B,
                               compute_dtype=dtype, with_attn=True,
                               device=dev)
        kernels.reset_launch_counts()
        res = engine(chunk)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"{path}: launches {json.dumps(launches)}")
        require(launches == want, f"{path}: expected launches {want}")
        require(bool(np.isfinite(res.logits).all()), f"{path}: non-finite")
        if path == "off_fp32_batched":
            err = float(np.abs(res.logits - on.logits).max())
            same = all(a == b for a, b in zip(top81(res.cls_token_attn),
                                              top81(on.cls_token_attn)))
            log(f"{path} vs the kernel-on fp32 forward: logits max abs err "
                f"{err!r}, same top-81 sets {same}")
            require(err <= 1e-4 and same, f"{path}: differs from the "
                    "kernel-on structure")
        else:
            bf16_contract(f"{path} vs kernel-on fp32 (recorded)", res, on)
            if path == "off_bf16_speed_k2":
                bf16_contract(f"{path} vs kernel-on bf16 speed (recorded)",
                              res, on_speed)
                excess = np.abs(res.logits - on.logits) - (
                    2e-2 * float(np.abs(on.logits).max())
                    + 2e-2 * np.abs(on.logits))
                require(bool((excess <= 0).all()),
                        f"{path}: logits outside phase 5's bound")
        probe = engine.throughput_probe(n_images=OFF_PROBE_IMAGES, reps=2)
        log(f"{path}: throughput_probe {json.dumps(probe)}")
        results[path] = {"launches": launches,
                         "img_per_sec": probe["img_per_sec"]}
        if path == "off_bf16_speed_k2":
            with first_call(deit, "fused_map_stats") as k2:
                engine._forward(torch.from_numpy(chunk).to(dev))
            fmap = k2[0][0][0].clone()
            require(fmap.dtype == torch.bfloat16, "K2 speed: map not bf16")
            records["fused_map_stats[bf16,speed]"] = k2_record(fmap, False)
            del k2
        del engine
    return results, records


def unpruned_phase(dev: torch.device) -> dict:
    """``BaseNet`` and ``DistilledDeiT`` over DeiT-Tiny/16@224 (seeded
    weights), B=32, fp32 (TF32 off): the eval forward launches no kernel
    (no policy, as in the JAX package), and the logits of 8 images are
    within 1e-4 of the CPU's. Returns {path: {"launches", "ms"}}."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.core.config import backbone_preset
    from protopformer_tpu_torch.models import (
        construct_basenet,
        construct_distilled_deit,
    )
    from protopformer_tpu_torch.serving import no_tf32

    gen = torch.Generator().manual_seed(11)
    x = torch.randn((UNPRUNED_B, 224, 224, 3), generator=gen)
    builders = {
        "basenet": lambda device: construct_basenet(
            backbone_preset("deit_tiny_patch16_224"), 200, torch.float32,
            torch.Generator().manual_seed(12), device=device),
        "distilled": lambda device: construct_distilled_deit(
            backbone_preset("deit_tiny_distilled_patch16_224"), 1000,
            torch.float32, torch.Generator().manual_seed(13), device=device),
    }
    results = {}
    for path, build in builders.items():
        model = build(dev)
        xd = x.to(dev)
        with torch.inference_mode(), no_tf32():
            kernels.reset_launch_counts()
            out = model(xd)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            ms = time_ms(lambda: model(xd), warmup=1, iters=5)
        logits = out[0] if isinstance(out, tuple) else out
        with torch.inference_mode():
            cpu = build("cpu")(x[:8])
        cpu = cpu[0] if isinstance(cpu, tuple) else cpu
        err = max_err(logits[:8].cpu(), cpu)
        log(f"{path} B={UNPRUNED_B} fp32: launches {json.dumps(launches)}; "
            f"logits {tuple(logits.shape)}, card vs cpu (8 images) max abs "
            f"err {err!r} (tolerance 1e-4); {ms:.2f} ms a forward")
        require(launches == NO_LAUNCHES, f"{path}: a kernel launched")
        require(err <= 1e-4, f"{path}: card vs CPU outside tolerance")
        results[path] = {"launches": launches, "ms": ms}
        del model
    return results


def width_phase(dev: torch.device, rng: np.random.Generator,
                state_dict) -> tuple:
    """Phase 4f (see the module docstring). Returns ({path: {...}},
    {record name: partial record})."""
    paths, records = {}, {}
    t0 = time.perf_counter()
    served, recs, s_weights, s_chunk = serve_width(
        dev, "deit_small_patch16_224",
        ("bf16_speed", "bf16_exact", "fp32_parity"), rng, hold_vs_fp32=True)
    paths.update(served)
    records.update(recs)
    paths.update(push_phase(dev, s_weights, s_chunk))
    del s_weights
    log(f"deit_s: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # phase 5's contract was set at DeiT-Tiny's width: DeiT-B's bf16
    # selection against fp32 is recorded, not held (PERF.md §6)
    served, recs, _, _ = serve_width(dev, "deit_base_patch16_224",
                                     ("bf16_speed", "fp32_parity"), rng,
                                     hold_vs_fp32=False)
    paths.update(served)
    records.update(recs)
    log(f"deit_b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    off, recs = kernel_off_phase(dev, state_dict, rng)
    paths.update(off)
    records.update(recs)
    paths.update(unpruned_phase(dev))
    log(f"kernel-off and unpruned: {time.perf_counter() - t0:.1f} s")
    return paths, records


# --- phase 4g: token counts above 256 (DeiT-B/16@384, deit_tiny_patch2_32) ------

LONG_N = 577  # DeiT-B/16@384: 24 x 24 patches and the CLS token


def k3_bf16_long_reading(qkv: torch.Tensor, pol, heads: int,
                         real_n: int) -> None:
    """K3's bf16 long kernel (``bf16k::mean_long_kernel``, K4's and K5's
    attention phase above 256 tokens; its launches count as K4's or K5's)
    on their operands: its time beside its plain version's and its bound,
    and its blocks an SM and shared memory, printed (out within 1e-2, the
    map within 1e-6, as ``k3_record``)."""
    from protopformer_tpu_torch.kernels import _build
    from protopformer_tpu_torch.kernels import attention_core as ac

    b, n, c3 = qkv.shape
    c = c3 // 3
    lib = _build.library()
    log_resident(f"K3 bf16 long kernel at NP={n}, hd={c // heads}",
                 lib.ppf_attention_mean_bf16_resident_blocks(n, c // heads),
                 lib.ppf_attention_mean_smem_bytes(n, c // heads, 1))
    pol = torch.ones((b, n), device=qkv.device) if pol is None else pol
    kernel = lambda: ac.fused_attention_mean_padded(qkv, pol, heads, real_n)
    plain = lambda: ac.mean_padded_plain(qkv, pol, heads, real_n)
    out, fmap = kernel()
    p_out, p_map = plain()
    torch.cuda.synchronize()
    errs = {"out": max_err(out, p_out), "map": max_err(fmap, p_map)}
    require(errs["out"] <= 1e-2 and errs["map"] <= 1e-6,
            f"K3 bf16 NP={n} real_n={real_n}: outside tolerance")
    nbytes = b * n * c3 * 2 + b * n * 4 + b * n * c * 2 + b * n * n * 4
    bound_ms, bound_by = bound(nbytes, (4.0 * b * n * n * c, BF16_FLOPS))
    log(f"K3 bf16 long NP={n} real_n={real_n} H={heads} B={b} (the "
        "attention phase, on the K4/K5 call's operands): " + json.dumps({
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": errs}))


def thresh_records(k4_args: dict, n: int) -> dict:
    """Each K4 on its thresh forward's own qkv (``core_record``), and K3's
    bf16 long kernel on the bf16 one's (``k3_bf16_long_reading``)."""
    records = {}
    for path, (args, _) in k4_args.items():
        qkv, pol, heads, ratio, identity_weight = args
        require((ratio, identity_weight) == (DISCARD, 0.2),
                f"{path}: K4 called with discard {ratio}, identity weight "
                f"{identity_weight}")
        dtype = "bf16" if qkv.dtype == torch.bfloat16 else "fp32"
        name = f"fused_attention_core[{dtype},N={n},H={heads}]"
        records[name] = core_record(name, qkv.clone(), pol, n, heads)
        if dtype == "bf16":
            k3_bf16_long_reading(qkv, pol, heads, n)
    return records


def long_phase(dev: torch.device, rng: np.random.Generator) -> tuple:
    """Phase 4g (see the module docstring). Returns ({path: {...}},
    {record name: partial record})."""
    from protopformer_tpu_torch.cli.bench_kernels import bench_inputs

    paths, records = {}, {}
    modes = ("bf16_speed", "bf16_exact", "fp32_parity")
    t0 = time.perf_counter()
    # the serving contract's bf16 selection was set at DeiT-Tiny's width
    # and 197 tokens: DeiT-B/16@384's bf16 readings are recorded, not held
    served, recs, weights, _ = serve_width(dev, "deit_base_patch16_384",
                                           modes, rng, hold_vs_fp32=False)
    paths.update(served)
    records.update(recs)
    log(f"deit_b384 serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the selection contract against the CPU's bf16 forward was set at
    # DeiT-Tiny's width and 197 tokens: recorded here, with a witness
    thr, k4_args = thresh(dev, weights, rng, "deit_base_patch16_384",
                          "deit_b384_thresh", hold_bf16_selection=False)
    paths.update(thr)
    del weights
    records.update(thresh_records(k4_args, LONG_N))
    del k4_args
    log(f"deit_b384 thresh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the kernel bench at 577 tokens: K5 on real 577 in NP 640
    paths.update(bench(dev, LONG_N, f"bench_{LONG_N}"))
    x = bench_inputs(dev, tokens=LONG_N)
    name = f"fused_attention_core_padded[bf16,bench,N={LONG_N}]"
    records[name] = core_record(name, x["qkv_pad"], x["policy_pad"], LONG_N,
                                H)
    k3_bf16_long_reading(x["qkv_pad"], x["policy_pad"], H, LONG_N)
    del x
    log(f"bench at {LONG_N}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served, recs, _, _ = serve_width(dev, "deit_tiny_patch2_32", modes, rng,
                                     hold_vs_fp32=False)
    paths.update(served)
    records.update(recs)
    log(f"deit_t_p2 serving: {time.perf_counter() - t0:.1f} s")
    return paths, records


# --- phase 4h: past 640 tokens (DeiT-Tiny/16 at 448 and 512 px) ---------------

T448_N = 785  # DeiT-Tiny/16 at 448 px: CLS + 28 x 28 patches


def past_640_phase(dev: torch.device, rng: np.random.Generator) -> tuple:
    """Phase 4h (see the module docstring). Returns ({path: {...}},
    {record name: partial record})."""
    from protopformer_tpu_torch.cli.bench_kernels import bench_inputs

    paths, records = {}, {}
    n = T448_N
    t0 = time.perf_counter()
    served, recs, weights, _ = serve_width(
        dev, "deit_tiny_patch16_224@448",
        ("bf16_speed", "bf16_exact", "fp32_parity"), rng, hold_vs_fp32=False)
    paths.update(served)
    records.update(recs)
    log(f"deit_t448 serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # serving's selection contract was set on 2 images at 197 tokens: at
    # 785 bf16 exact's selection is recorded against both CPU forwards,
    # beside bf16_witness's 160-image readings (kernels and their plain
    # versions on the card)
    thr, k4_args = thresh(dev, weights, rng, "deit_tiny_patch16_224@448",
                          "deit_t448_thresh", hold_bf16_selection=False,
                          hold_fp32_selection=False)
    paths.update(thr)
    del weights
    records.update(thresh_records(k4_args, n))
    del k4_args
    log(f"deit_t448 thresh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the kernel bench at 785 tokens: K5 on real 785 in NP 896
    paths.update(bench(dev, n, f"bench_{n}"))
    x = bench_inputs(dev, tokens=n)
    name = f"fused_attention_core_padded[bf16,bench,N={n}]"
    records[name] = core_record(name, x["qkv_pad"], x["policy_pad"], n, H)
    k3_bf16_long_reading(x["qkv_pad"], x["policy_pad"], H, n)
    del x
    log(f"bench at {n}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # 1,025 tokens: the map select's bands no longer fit shared memory
    served, recs, _, _ = serve_width(dev, "deit_tiny_patch16_224@512",
                                     ("bf16_speed", "fp32_parity"), rng,
                                     hold_vs_fp32=False)
    paths.update(served)
    records.update(recs)
    log(f"deit_t512 serving: {time.perf_counter() - t0:.1f} s")
    return paths, records


# --- phase 4i: the data layer feeding the trainer ------------------------------

DATA_CLASSES = 200  # CUB-200-2011's classes
DATA_TRAIN_PER_CLASS = 3  # images a class: 600 train images, 4 steps of 128
DATA_TEST_PER_CLASS = 1  # 200 eval images: batches of 128 and 72 (+ pads)
DATA_WORKERS = 8
DATA_EPOCHS = 3
# CUB-200-2011's own image sizes: the longer side 500 px
DATA_SIZES = ((500, 375), (375, 500), (500, 333), (500, 500))


def write_cub_tree(root: Path, seed: int) -> None:
    """A CUB-200-2011 tree of seeded JPEGs at the dataset's sizes: per class
    a base colour under noise (a pattern a model can learn in a few steps),
    with images.txt, image_class_labels.txt, train_test_split.txt and
    bounding_boxes.txt as the stock metadata has them."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = root / "CUB_200_2011"
    colours = rng.integers(30, 226, size=(DATA_CLASSES, 3))
    per_class = DATA_TRAIN_PER_CLASS + DATA_TEST_PER_CLASS
    lines = {"images": [], "labels": [], "split": [], "boxes": []}
    for c in range(DATA_CLASSES):
        folder = f"{c + 1:03d}.Class_{c + 1}"
        (base / "images" / folder).mkdir(parents=True, exist_ok=True)
        for k in range(per_class):
            i = c * per_class + k + 1
            w, h = DATA_SIZES[i % len(DATA_SIZES)]
            noise = rng.normal(0.0, 40.0, size=(h // 4, w // 4, 3))
            img = np.clip(colours[c] + np.kron(noise, np.ones((4, 4, 1))),
                          0, 255).astype(np.uint8)
            name = f"{folder}/Class_{c + 1}_{k}.jpg"
            Image.fromarray(img).save(base / "images" / name, quality=90)
            lines["images"].append(f"{i} {name}")
            lines["labels"].append(f"{i} {c + 1}")
            lines["split"].append(f"{i} {int(k < DATA_TRAIN_PER_CLASS)}")
            lines["boxes"].append(f"{i} {w * 0.1:.1f} {h * 0.1:.1f} "
                                  f"{w * 0.8:.1f} {h * 0.8:.1f}")
    for fname, key in (("images.txt", "images"),
                       ("image_class_labels.txt", "labels"),
                       ("train_test_split.txt", "split"),
                       ("bounding_boxes.txt", "boxes")):
        (base / fname).write_text("\n".join(lines[key]) + "\n")


def data_phase(dev: torch.device) -> dict:
    """Phase 4i (see the module docstring). Returns {path: {"launches",
    "img_per_sec"}}."""
    import shutil
    import tempfile

    from protopformer_tpu_torch import kernels, train
    from protopformer_tpu_torch.core.config import (
        ExperimentConfig,
        PPNetConfig,
        backbone_preset,
    )
    from protopformer_tpu_torch.data import (
        HostDataLoader,
        MixupCutmix,
        build_dataset_index,
        build_eval_transform,
        build_train_transform,
        native,
    )

    results = {}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cub_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        write_cub_tree(tmp, seed=21)
        log(f"data: wrote {DATA_CLASSES} classes x "
            f"{DATA_TRAIN_PER_CLASS + DATA_TEST_PER_CLASS} JPEGs in "
            f"{time.perf_counter() - t0:.1f} s")
        # main_train.py's data flags: CUB2011U (the raw tree), the train
        # transform at 224 with RandAugment rand-m9-mstd0.5-inc1 and
        # RandomErasing 0.25 (colour jitter off under auto-augment)
        cfg = ExperimentConfig()
        train_index = build_dataset_index("CUB2011U", str(tmp), train=True)
        eval_index = build_dataset_index("CUB2011U", str(tmp), train=False)
        require(len(train_index) == DATA_CLASSES * DATA_TRAIN_PER_CLASS
                and len(eval_index) == DATA_CLASSES * DATA_TEST_PER_CLASS
                and train_index.num_classes == 200,
                "data: the CUB index does not match the tree")
        args = (224, cfg.data.color_jitter, cfg.data.aa, cfg.data.reprob)
        use_native = native.is_available()
        path_tf = (native.build_native_train_transform(*args) if use_native
                   else None)
        eval_path_tf = (native.build_native_eval_transform(224) if use_native
                        else None)
        log(f"data: native image pipeline available: {use_native} "
            f"({native.library_path()}); the train path runs "
            f"{'the native decoder' if use_native else 'PIL'}")
        train_loader = HostDataLoader(
            train_index, build_train_transform(*args), TRAIN_B, shuffle=True,
            seed=cfg.train.seed, drop_last=True, num_workers=DATA_WORKERS,
            path_transform=path_tf)
        eval_loader = HostDataLoader(
            eval_index, build_eval_transform(224), TRAIN_B, shuffle=False,
            seed=cfg.train.seed, num_workers=DATA_WORKERS,
            path_transform=eval_path_tf)
        # the loader alone: one epoch of decode + augment + batch
        t0 = time.perf_counter()
        batches = list(train_loader)
        loader_s = time.perf_counter() - t0
        shapes = {tuple(b["image"].shape) for b in batches}
        require(shapes == {(TRAIN_B, 224, 224, 3)}
                and all(np.isfinite(b["image"]).all() for b in batches),
                f"data: train batches of shapes {shapes}")
        loader_ips = len(batches) * TRAIN_B / loader_s
        log(f"data: the train loader alone, {len(batches)} batches of "
            f"{TRAIN_B} with {DATA_WORKERS} workers: {loader_ips:.1f} img/s "
            "(host)")

        ppnet = PPNetConfig()
        backbone = backbone_preset("deit_tiny_patch16_224")
        state, plain_step = train_setup(backbone, ppnet, torch.bfloat16, dev,
                                        seed=22)
        mix_step = train.make_train_step(
            state.model, ppnet, cfg.optim, device=dev,
            mixup=MixupCutmix(mixup_alpha=cfg.data.mixup,
                              cutmix_alpha=cfg.data.cutmix,
                              prob=cfg.data.mixup_prob,
                              switch_prob=cfg.data.mixup_switch_prob,
                              num_classes=ppnet.num_classes))
        # the preset's first full-LR epoch (after its 5 warm-up epochs)
        state.step = 5 * TRAIN_STEPS_PER_EPOCH
        mix_at = state.step + 1
        losses, mixed = [], []

        def step(st, batch, gen, gate):
            use_mix = st.step == mix_at
            st, metrics = (mix_step if use_mix else plain_step)(
                st, batch, gen, gate)
            losses.append(metrics["loss"])
            mixed.append(use_mix)
            return st, metrics

        gen = torch.Generator(dev).manual_seed(3)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for epoch in range(DATA_EPOCHS):
            state, stats, _ = train.train_one_epoch(
                step, state, train_loader, epoch, gen, cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = kernels.launch_counts()
        losses = torch.stack(losses).tolist()
        steps = len(losses)
        per_epoch = steps // DATA_EPOCHS
        first = sum(losses[:per_epoch]) / per_epoch
        last = sum(losses[-per_epoch:]) / per_epoch
        step_ips = steps * TRAIN_B / train_s
        log(f"data: train_one_epoch x {DATA_EPOCHS} from the loader, bf16, "
            f"B={TRAIN_B}: {steps} steps in {train_s:.2f} s, "
            f"{step_ips:.1f} img/s (loader included); losses "
            f"{json.dumps(losses)}; step {mixed.index(True)} with "
            f"MixupCutmix (cutmix {cfg.data.cutmix}); mean loss of the "
            f"first epoch {first!r}, of the last {last!r}")
        require(sum(mixed) == 1, "data: the mixup step did not run once")
        want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
        require(train_launches == want,
                f"data: the train steps launched {train_launches}, not {want}")
        require(all(math.isfinite(v) for v in losses) and last < first,
                "data: the mean loss did not fall over the epochs")
        # the step fed from the loader: its time and the device's idle
        # share over two steps whose batches come from the loader
        feed = iter(train_loader)

        def loader_step():
            return plain_step(state, next(feed), gen, 1.0)[1]

        prof = profile_chunk(loader_step, reps=1)
        for _ in feed:  # the epoch's remaining batches
            pass
        log(f"data: one loader-fed train step, profile {json.dumps(prof)}")
        results["data_train"] = {"img_per_sec": step_ips,
                                 "launches": train_launches}
        # evaluate over the eval loader: the serving forward's kernels a
        # batch (K1 x 11, K3 x 1), the last batch padded and masked
        eval_step = train.make_eval_step(device=dev)
        kernels.reset_launch_counts()
        res = train.evaluate(eval_step, state.model, eval_loader)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = expected_launches("bf16_exact", len(eval_loader))
        log(f"data: evaluate over {len(eval_index)} images in "
            f"{len(eval_loader)} batches {json.dumps(res)}; launches "
            f"{json.dumps(launches)}")
        require(launches == want, f"data: evaluate expected launches {want}")
        require(all(math.isfinite(v) for v in res.values())
                and 0.0 <= res["acc1"] <= res["acc5"] <= 100.0,
                "data: evaluate out of range")
        results["data_eval"] = {"launches": launches}
        log("data: " + json.dumps({
            "loader_img_per_sec": loader_ips,
            "train_step_img_per_sec": step_ips,
            "train_step_idle_share": prof["idle_share"],
            "native_path_ran": use_native,
            "mean_loss_first_epoch": first, "mean_loss_last_epoch": last}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results


# --- phase 4j: the offline user path ----------------------------------------

CUB_PARTS = ("back", "beak", "belly", "breast", "crown", "forehead",
             "left eye", "left leg", "left wing", "nape", "right eye",
             "right leg", "right wing", "tail", "throat")
# cli/presets/train_cub.sh's flags (the reference's scripts/train_cub.sh)
# but its batch (TRAIN_B, the preset's 128) and epochs, on the host's 8 cores
CUB_PRESET = [
    "--base_architecture=deit_tiny_patch16_224", "--data_set=CUB2011U",
    "--input_size=224", "--model=deit_tiny_patch16_224", "--seed=1028", "--opt=adamw", "--sched=cosine", "--warmup-epochs=5",
    "--warmup-lr=1e-4", "--decay-epochs=10", "--decay-rate=0.1",
    "--weight_decay=0.05", "--features_lr=1e-4", "--add_on_layers_lr=3e-3",
    "--prototype_vectors_lr=3e-3", "--prototype_shape", "2000", "192", "1",
    "1", "--reserve_layers", "11", "--reserve_token_nums", "81",
    "--use_global=True", "--use_ppc_loss=True", "--ppc_cov_thresh=1.",
    "--ppc_mean_thresh=2.", "--global_coe=0.5", "--global_proto_per_class=10",
    "--ppc_cov_coe=0.1", "--ppc_mean_coe=0.5", "--num_workers=8",
]
# cli/presets/visualize.sh's and eval_interpretability.sh's model flags
TOOL_FLAGS = ["--base_architecture=deit_tiny_patch16_224",
              "--prototype_shape", "2000", "192", "1", "1",
              "--reserve_layers", "11", "--reserve_token_nums", "81",
              "--global_proto_per_class=10"]
VIS_CLASSES = 2
VIS_B = 64
INTERP_B = 256


def write_cub_parts(root: Path, seed: int) -> int:
    """parts/parts.txt and parts/part_locs.txt for the tree under ``root``:
    15 parts an image at seeded places inside it, each invisible (0 0 0)
    with probability 0.2, as CUB-200-2011 marks them. Returns the images."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = root / "CUB_200_2011"
    (base / "parts").mkdir(exist_ok=True)
    (base / "parts" / "parts.txt").write_text(
        "".join(f"{i + 1} {name}\n" for i, name in enumerate(CUB_PARTS)))
    lines = []
    images = [ln.split() for ln in (base / "images.txt").read_text().split(
        "\n") if ln.strip()]
    for img_id, name in images:
        with Image.open(base / "images" / name) as im:
            w, h = im.size
        for part in range(1, len(CUB_PARTS) + 1):
            if rng.uniform() < 0.2:
                lines.append(f"{img_id} {part} 0.0 0.0 0")
            else:
                lines.append(f"{img_id} {part} {rng.uniform(0, w):.1f} "
                             f"{rng.uniform(0, h):.1f} 1")
    (base / "parts" / "part_locs.txt").write_text("\n".join(lines) + "\n")
    return len(images)


def write_pretrained(path: Path, seed: int) -> None:
    """A seeded DeiT-Tiny/16@224 in the timm/FB layout: ``{"model": ...}``
    with ``module.``-prefixed keys (DataParallel's) and a 1000-class head."""
    from protopformer_tpu_torch.models import create_backbone
    from protopformer_tpu_torch.models.layers import seeded_init_

    gen = torch.Generator().manual_seed(seed)
    backbone = create_backbone("deit_tiny_patch16_224")
    with torch.no_grad():
        seeded_init_(backbone, backbone, "deit", 1e-5, gen)
    sd = dict(backbone.state_dict())
    sd["head.weight"] = torch.randn(1000, 192, generator=gen) * 0.02
    sd["head.bias"] = torch.zeros(1000)
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)


def run_cli(what: str, fn) -> tuple:
    """(result, launches, host seconds) of one in-process CLI run with the
    launch counters set to 0 just before it."""
    from protopformer_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"offline: {what} in {seconds:.2f} s; launches {json.dumps(launches)}")
    return result, launches, seconds


def _times(launches: dict, n: int) -> dict:
    return {k: v * n for k, v in launches.items()}


def _add(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def offline_phase(dev: torch.device) -> dict:
    """Phase 4j (see the module docstring). Returns {path: {"launches"}}."""
    import shutil
    import tempfile

    from protopformer_tpu_torch.checkpoint import load_torch_checkpoint
    from protopformer_tpu_torch.cli import eval_interpretability
    from protopformer_tpu_torch.cli import export as export_cli
    from protopformer_tpu_torch.cli import train as train_cli
    from protopformer_tpu_torch.cli import visualize
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.serving import ServingEngine
    from protopformer_tpu_torch.tools.visualize import push

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="offline_", dir=ROOT / "build"))
    try:
        write_cub_tree(tmp, seed=31)
        n_images = write_cub_parts(tmp, seed=32)
        pretrained = tmp / "deit_tiny_patch16_224.pth"
        write_pretrained(pretrained, seed=33)
        out = tmp / "out"
        n_train = DATA_CLASSES * DATA_TRAIN_PER_CLASS
        n_test = DATA_CLASSES * DATA_TEST_PER_CLASS
        log(f"offline: a CUB tree of {n_images} JPEGs with 15 parts each, "
            f"a seeded timm-layout DeiT-Tiny/16@224 .pth "
            f"({pretrained.stat().st_size / 2 ** 20:.1f} MiB)")
        parser = train_cli.get_args_parser()
        device = f"--device={dev.type}"  # the CLIs' default on the card
        base = [*CUB_PRESET, f"--batch_size={TRAIN_B}", f"--data_path={tmp}",
                f"--output_dir={out}", "--save_ep_freq=1", device]
        steps = n_train // TRAIN_B
        val_batches = -(-n_test // int(1.5 * TRAIN_B))
        train_launches = _add(_times(TRAIN_LAUNCHES, steps),
                              expected_launches("bf16_exact", val_batches))

        # train 2 epochs from the pretrained backbone, then a third resumed
        first, l_first, s_first = run_cli(
            "cli.train, 2 epochs from --pretrained_ckpt",
            lambda: train_cli.main(parser.parse_args(
                base + ["--epochs=2", f"--pretrained_ckpt={pretrained}"])))
        require(l_first == _times(train_launches, 2),
                f"offline: cli.train launched {l_first}")
        second, l_second, s_second = run_cli(
            "cli.train --resume <root>, epoch 3",
            lambda: train_cli.main(parser.parse_args(
                base + ["--epochs=3", f"--resume={out / 'checkpoints'}"])))
        require(l_second == train_launches,
                f"offline: the resumed cli.train launched {l_second}")
        epochs = first["epochs"] + second["epochs"]
        require([e["epoch"] for e in epochs] == [0, 1, 2]
                and sorted(os.listdir(out / "checkpoints")) == [
                    f"checkpoint-{e}.pth" for e in range(3)],
                f"offline: epochs {[e['epoch'] for e in epochs]}, files "
                f"{sorted(os.listdir(out / 'checkpoints'))}")
        metrics = [json.loads(ln) for ln in
                   (out / "metrics.jsonl").read_text().splitlines()]
        logged = [m for m in metrics if "epoch/val_acc1" in m]
        require(all(math.isfinite(m["train/loss"]) for m in metrics
                    if "train/loss" in m) and len(logged) == 3,
                "offline: the train losses or the epoch records")
        last = out / "checkpoints" / "checkpoint-2.pth"
        stats, l_eval, _ = run_cli(
            "cli.train --eval --resume <epoch 2's file>",
            lambda: train_cli.main(parser.parse_args(
                base + ["--epochs=3", "--eval", f"--resume={last}"])))
        require(l_eval == expected_launches("bf16_exact", val_batches),
                f"offline: --eval launched {l_eval}")
        require(stats["acc1"] == logged[2]["epoch/val_acc1"]
                and stats["loss"] == logged[2]["epoch/val_loss"],
                f"offline: --eval {stats} does not reproduce epoch 2's "
                f"logged acc1 {logged[2]['epoch/val_acc1']!r} and loss "
                f"{logged[2]['epoch/val_loss']!r}")

        # export the EMA weights, serve them, run the tools on them
        export_path = tmp / "export.pth"
        run_cli("cli.export --use_ema", lambda: export_cli.main(
            export_cli.get_parser().parse_args(
                [*CUB_PRESET, f"--resume={last}", "--use_ema",
                 f"--export_path={export_path}", device])))
        exported = torch.load(export_path, map_location="cpu",
                              weights_only=True)["model"]
        ema = torch.load(last, map_location="cpu",
                         weights_only=True)["model_ema"]
        require(exported.keys() == ema.keys()
                and all(torch.equal(exported[k], ema[k]) for k in ema),
                "offline: the export is not the checkpoint's model_ema")
        backbone = backbone_preset("deit_tiny_patch16_224")
        ppnet = PPNetConfig()
        engine = ServingEngine(backbone, ppnet, load_torch_checkpoint(
            str(export_path)), device=dev)
        request = np.random.default_rng(34).integers(
            0, 256, (B, 224, 224, 3), dtype=np.uint8)
        served, l_serve, _ = run_cli("ServingEngine on the export, 160 images",
                                     lambda: engine(request))
        require(served.logits.shape == (B, 200)
                and np.isfinite(served.logits).all()
                and l_serve == expected_launches("bf16_exact", 1),
                f"offline: serving the export launched {l_serve}")

        # the Gaussian figures are matplotlib's, which the card's machine
        # may lack; the forward and the rest of the outputs are the same
        gauss = importlib.util.find_spec("matplotlib") is not None
        vis_dir = tmp / "vis"
        written, l_vis, s_vis = run_cli(
            f"cli.visualize slim_gaussian{' --use_gauss' * gauss}, "
            f"{VIS_CLASSES} classes (matplotlib "
            f"{'present' if gauss else 'missing'})",
            lambda: visualize.main([
                *TOOL_FLAGS, "--data_set=CUB2011U", f"--data_path={tmp}",
                f"--resume={export_path}", f"--output_dir={vis_dir}",
                "--vis_classes", *map(str, range(VIS_CLASSES)),
                *["--use_gauss"] * gauss, "--visual_type=slim_gaussian",
                f"--batch_size={VIS_B}", device]))
        want_files = VIS_CLASSES * DATA_TEST_PER_CLASS * ((1 + gauss) * 10 + 1)
        require(len(written) == want_files == len(list(vis_dir.rglob("*.png"))),
                f"offline: cli.visualize wrote {len(written)} files, not "
                f"{want_files}")
        vis_batches = -(-n_test // VIS_B)
        require(l_vis == expected_launches("fp32_parity", vis_batches),
                f"offline: cli.visualize launched {l_vis}")
        interp = [*TOOL_FLAGS, f"--data_path={tmp / 'CUB_200_2011'}",
                  f"--resume={export_path}", f"--batch_size={INTERP_B}"]
        score, l_interp, s_interp = run_cli(
            "cli.eval_interpretability on the card",
            lambda: eval_interpretability.main(interp + [device]))
        require(l_interp == expected_launches("fp32_parity",
                                              -(-n_test // INTERP_B)),
                f"offline: cli.eval_interpretability launched {l_interp}")
        cpu_score, _, s_cpu = run_cli(
            "cli.eval_interpretability on the CPU",
            lambda: eval_interpretability.main(interp + ["--device=cpu"]))
        require(score == cpu_score and 0.0 < score <= 100.0,
                f"offline: consistency score {score!r} on the card, "
                f"{cpu_score!r} on the CPU")

        # the tools' forward alone: push on a device-resident batch of 160
        model = construct_ppnet(backbone, ppnet)
        model.load_state_dict(exported)
        model.to(dev)
        x = torch.rand((B, 224, 224, 3), generator=torch.Generator(
        ).manual_seed(35)).to(dev)
        push_ips = B / time_ms(lambda: push(model, x), 2, 5) * 1e3
        log("offline: " + json.dumps({
            "cli_train_img_per_sec": [e["img_per_sec"] for e in epochs],
            "checkpoint_save_seconds": [e["save_seconds"] for e in epochs],
            "cli_train_seconds": [s_first, s_second],
            "val_acc1": [m["epoch/val_acc1"] for m in logged],
            "val_loss": [m["epoch/val_loss"] for m in logged],
            "visualize_img_per_sec": n_test / s_vis,
            "visualize_files": len(written), "gaussian_figures": gauss,
            "interpretability_img_per_sec": n_test / s_interp,
            "interpretability_cpu_img_per_sec": n_test / s_cpu,
            "consistency_score": score,
            "push_fp32_img_per_sec": push_ips}))
        return {"cli_train": {"launches": _add(l_first, l_second)},
                "cli_eval": {"launches": l_eval},
                "offline_serve": {"launches": l_serve},
                "tools_fp32": {"launches": _add(l_vis, l_interp)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- main ----------------------------------------------------------------------

# --- phase 4k: several cards, int8 serving, the LayerNorm options, profiling ---

DDP_TIMED_STEPS = 10
DDP_LIMIT_S = 300  # a hard limit on every rank process


def ddp_case_devices() -> list:
    """(backend, a device a rank) of each data-parallel case: NCCL over
    every card, and where there are fewer than two, two gloo ranks sharing
    card 0 (NCCL refuses two ranks on one device)."""
    n = torch.cuda.device_count()
    cases = [("nccl", [f"cuda:{r}" for r in range(n)])]
    if n < 2:
        cases.append(("gloo", ["cuda:0", "cuda:0"]))
    return cases


def ddp_model(weights: str):
    """The CUB preset's DeiT-Tiny/16@224 PPNet in fp32, drop path 0 (a
    rank's generator is seeded seed + rank, so no draw is shared), with
    the saved weights; its config and optimizer config."""
    from protopformer_tpu_torch.core.config import (
        OptimConfig,
        PPNetConfig,
        backbone_preset,
    )
    from protopformer_tpu_torch.models import construct_ppnet

    backbone = backbone_preset("deit_tiny_patch16_224", drop_path_rate=0.0)
    ppnet, optim = PPNetConfig(), OptimConfig()
    model = construct_ppnet(backbone, ppnet, torch.float32)
    model.load_state_dict(torch.load(weights), strict=True)
    return model, ppnet, optim


def ddp_worker(argv: list) -> int:
    """One rank of phase 4k's data-parallel training:
    ``chip_smoke.py --ddp-worker <rank> <world> <port> <job.json>``. It
    joins the group over the job's backend, takes its contiguous rows of
    the global batch on its card, runs one fp32 step (rank 0 saves its
    gradients and parameters), one step with the launch counters set to 0
    just before it, 2 more, then the job's timed steps, and prints one
    JSON line."""
    import torch.distributed as dist

    from protopformer_tpu_torch import kernels, train
    from protopformer_tpu_torch.parallel import initialize_multihost

    rank, world, port = int(argv[0]), int(argv[1]), argv[2]
    with open(argv[3]) as f:
        job = json.load(f)
    dev = torch.device(job["devices"][rank])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    if world == 1:  # the helper leaves one process alone: join it here
        dist.init_process_group(job["backend"],
                                init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    else:
        initialize_multihost(f"localhost:{port}", world, rank,
                             backend=job["backend"])
    model, ppnet, optim = ddp_model(job["weights"])
    state = train.create_train_state(
        model, train.make_optimizer(optim, model, TRAIN_STEPS_PER_EPOCH),
        device=dev)
    step = train.make_train_step(model, ppnet, optim, device=dev,
                                 distributed=True)
    full = torch.load(job["batch"])
    b = len(full["label"]) // world
    batch = {k: v[rank * b:(rank + 1) * b].to(dev) for k, v in full.items()}
    gen = torch.Generator(dev).manual_seed(job["seed"] + rank)
    first = {k: float(v) for k, v in step(state, batch, gen, 1.0)[1].items()}
    if rank == 0:
        torch.save({"grads": {n: p.grad.detach().cpu()
                              for n, p in model.named_parameters()
                              if p.grad is not None},
                    "params": {n: p.detach().cpu()
                               for n, p in model.named_parameters()}},
                   job["out"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    kernels.reset_launch_counts()
    step(state, batch, gen, 1.0)
    sync()
    launches = kernels.launch_counts()
    for _ in range(2):
        step(state, batch, gen, 1.0)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    losses = [step(state, batch, gen, 1.0)[1]["loss"]
              for _ in range(job["timed_steps"])]
    sync()
    ms = (time.perf_counter() - t0) / job["timed_steps"] * 1e3
    print(json.dumps({"rank": rank, "world": dist.get_world_size(),
                      "backend": dist.get_backend(), "device": str(dev),
                      "first": first, "launches": launches, "ms": ms,
                      "losses": torch.stack(losses).tolist()}), flush=True)
    dist.destroy_process_group()
    return 0


def run_ranks(job_path: Path, world: int) -> list:
    """Start ``world`` rank processes of this script on one job; wait for
    each within DDP_LIMIT_S, killing every rank on expiry or failure."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker", str(r),
         str(world), port, str(job_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=DDP_LIMIT_S)
            require(p.returncode == 0,
                    f"a data-parallel rank failed:\n{stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def ddp_phase(dev: torch.device) -> dict:
    """Phase 4k's data-parallel training (see the module docstring).
    Returns {path: {"launches", "ms_per_step", "img_per_sec"}}."""
    import tempfile

    from protopformer_tpu_torch import train
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ddp_", dir=ROOT / "build"))
    weights, batch_path = tmp / "weights.pt", tmp / "batch.pt"
    torch.save(construct_ppnet(
        backbone_preset("deit_tiny_patch16_224", drop_path_rate=0.0),
        PPNetConfig(), torch.float32,
        generator=torch.Generator().manual_seed(11)).state_dict(), weights)
    batch = train_batch(torch.device("cpu"), torch.Generator().manual_seed(12),
                        TRAIN_B)
    torch.save(batch, batch_path)

    def one_process(grads=None):
        """The one-process card step on the global batch from the saved
        weights, or with ``grads`` the optimizer step on those gradients."""
        model, ppnet, optim = ddp_model(str(weights))
        state = train.create_train_state(
            model, train.make_optimizer(optim, model, TRAIN_STEPS_PER_EPOCH),
            device=dev)
        if grads is not None:
            for n, p in model.named_parameters():
                p.grad = grads[n].to(dev) if n in grads else None
            state.apply_gradients()
            return {n: p.detach().cpu() for n, p in model.named_parameters()}
        step = train.make_train_step(model, ppnet, optim, device=dev)
        loss = float(step(state, {k: v.to(dev) for k, v in batch.items()},
                          torch.Generator(dev).manual_seed(0), 1.0)[1]["loss"])
        return loss, {n: (p.detach().cpu(), None if p.grad is None
                          else p.grad.detach().cpu())
                      for n, p in model.named_parameters()}

    ref_loss, ref = one_process()
    results = {}
    for backend, devices in ddp_case_devices():
        world = len(devices)
        job = tmp / f"{backend}.json"
        out = tmp / f"{backend}_rank0.pt"
        job.write_text(json.dumps({
            "devices": devices, "backend": backend, "weights": str(weights),
            "batch": str(batch_path), "seed": 1028, "out": str(out),
            "timed_steps": DDP_TIMED_STEPS}))
        t0 = time.perf_counter()
        ranks = sorted(run_ranks(job, world), key=lambda r: r["rank"])
        seconds = time.perf_counter() - t0
        got = torch.load(out)
        ddp = {n: (got["params"][n], got["grads"].get(n)) for n in ref}
        res = step_contract(ref, ddp, one_process(got["grads"]))
        res["loss"] = abs(ranks[0]["first"]["loss"] - ref_loss)
        path = f"ddp_{backend}"
        ms = max(r["ms"] for r in ranks)
        log(f"{path}: backend {ranks[0]['backend']}, {world} rank(s) on "
            f"{[r['device'] for r in ranks]}, global B={TRAIN_B} "
            f"({TRAIN_B // world} a rank), fp32 with TF32 off; "
            f"{ms:.2f} ms/step, {TRAIN_B / ms * 1e3:.1f} img/s over "
            f"{DDP_TIMED_STEPS} steps (the slowest rank); first step's "
            f"all-reduced loss a rank {[r['first']['loss'] for r in ranks]}; "
            f"against the one-process card step (loss {ref_loss!r}) "
            f"{json.dumps(res)}; launches of one step a rank "
            f"{json.dumps([r['launches'] for r in ranks])}; "
            f"{seconds:.1f} s with the ranks' start; {nvidia_smi_line()}")
        require(all(r["backend"] == backend and r["world"] == world
                    for r in ranks), f"{path}: not the backend asked for")
        require(len({r["first"]["loss"] for r in ranks}) == 1
                and all(r["losses"] == ranks[0]["losses"] for r in ranks),
                f"{path}: the ranks' all-reduced losses differ")
        require(all(math.isfinite(v) for v in ranks[0]["losses"]),
                f"{path}: non-finite loss")
        require(all(r["launches"] == TRAIN_LAUNCHES for r in ranks),
                f"{path}: expected launches {TRAIN_LAUNCHES} a rank")
        require(res["loss"] <= 1e-5 and res["holds"],
                f"{path}: outside the training contract of the one-process "
                "step")
        results[path] = {"launches": _add(*[r["launches"] for r in ranks]),
                         "ms_per_step": ms,
                         "img_per_sec": TRAIN_B / ms * 1e3}
    return results


def mesh_phase(dev: torch.device, state_dict,
               rng: np.random.Generator) -> dict:
    """Phase 4k's mesh engine: one fp32 replica a mesh device (every card,
    or card 0 twice where there is one), B=160 a device, against the
    one-device engine."""
    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.parallel import make_mesh
    from protopformer_tpu_torch.serving import ServingEngine

    ppnet, modes = model_configs()
    backbone, dtype = modes["fp32_parity"]
    mesh = make_mesh() if torch.cuda.device_count() >= 2 \
        else make_mesh([dev, dev])
    kw = dict(batch_size=B, compute_dtype=dtype, with_attn=True)
    single = ServingEngine(backbone, ppnet, state_dict, device=dev, **kw)
    engine = ServingEngine(backbone, ppnet, state_dict, mesh=mesh, **kw)
    imgs = rng.integers(0, 256, (B * mesh.size + 13, 224, 224, 3),
                        dtype=np.uint8)
    kernels.reset_launch_counts()
    single(imgs[:B])
    torch.cuda.synchronize()
    one_chunk = kernels.launch_counts()
    kernels.reset_launch_counts()
    engine(imgs[:B * mesh.size])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    got, want = engine(imgs), single(imgs)
    err = float(np.abs(got.logits - want.logits).max())
    same = all(a == b for a, b in zip(top81(got.cls_token_attn),
                                      top81(want.cls_token_attn)))
    probe = engine.throughput_probe(n_images=PROBE_IMAGES, reps=3)
    base = single.throughput_probe(n_images=PROBE_IMAGES, reps=3)
    log(f"mesh_fp32: {mesh}, B={B} a device; {len(imgs)} images against "
        f"the one-device engine: logits max abs err {err!r}, same top-81 "
        f"{same}, same top_class "
        f"{bool((got.top_class == want.top_class).all())}; launches of a "
        f"chunk {json.dumps(launches)} (one device's chunk "
        f"{json.dumps(one_chunk)}); img/s {probe['img_per_sec']!r} "
        f"(one device {base['img_per_sec']!r}); {nvidia_smi_line()}")
    require(err <= 1e-5 and same
            and bool((got.top_class == want.top_class).all()),
            "mesh_fp32: differs from the one-device engine")
    require(launches == {k: v * mesh.size for k, v in one_chunk.items()}
            and one_chunk == expected_launches("fp32_parity", 1),
            "mesh_fp32: a chunk did not launch each kernel once a device")
    return {"mesh_fp32": {"launches": launches,
                          "img_per_sec": probe["img_per_sec"]}}


def options_phase(dev: torch.device, state_dict,
                  rng: np.random.Generator) -> dict:
    """Phase 4k's serving options in bf16 speed mode at B=160: int8
    (``quantize="int8"``) and the two LayerNorm statistics options, each
    against the fp32 engine (phase 5's contract on 2 images, the readings
    over 160 recorded), with its launches and img/s beside plain bf16
    speed's; then a ``utils.profiling.trace`` of one int8 chunk."""
    import dataclasses
    import tempfile

    from protopformer_tpu_torch import kernels
    from protopformer_tpu_torch.serving import ServingEngine
    from protopformer_tpu_torch.utils import profiling

    ppnet, modes = model_configs()
    speed = modes["bf16_speed"][0]
    imgs = rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
    fp32 = ServingEngine(modes["fp32_parity"][0], ppnet, state_dict,
                         batch_size=B, compute_dtype=torch.float32,
                         with_attn=True, device=dev)
    ref = fp32(imgs)
    two = ref._replace(logits=ref.logits[:2],
                       cls_token_attn=ref.cls_token_attn[:2])
    results = {}
    for path, overrides in (("bf16_speed_plain", {}),
                            ("int8_bf16_speed", {"quantize": "int8"}),
                            ("ln_mxu_bf16_speed", {"ln_stats": "mxu"}),
                            ("ln_compute_bf16_speed",
                             {"ln_stats": "compute"})):
        engine = ServingEngine(dataclasses.replace(speed, **overrides),
                               ppnet, state_dict, batch_size=B,
                               compute_dtype=torch.bfloat16, with_attn=True,
                               device=dev)
        kernels.reset_launch_counts()
        got = engine(imgs)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        overlap, worst = selection(got.cls_token_attn, ref.cls_token_attn)
        probe = engine.throughput_probe(n_images=PROBE_IMAGES, reps=3)
        log(f"{path}: over {B} images against fp32, top-81 overlap min "
            f"{min(overlap)} mean {float(np.mean(overlap))!r}, images "
            f"dropping an fp32 rank below 64: "
            f"{sum(1 for r in worst if r is not None and r < 64)}; "
            f"launches {json.dumps(launches)}; img/s "
            f"{probe['img_per_sec']!r}; {nvidia_smi_line()}")
        held = bf16_contract(f"{path} vs fp32 (2 images)", got._replace(
            logits=got.logits[:2], cls_token_attn=got.cls_token_attn[:2]),
            two)
        require(held, f"{path}: outside phase 5's contract against fp32")
        require(launches == expected_launches("bf16_speed", 1),
                f"{path}: expected the bf16 speed launches")
        results[path] = {"launches": launches,
                         "img_per_sec": probe["img_per_sec"]}
        if overrides.get("quantize") == "int8":
            log(f"{path}: profile {json.dumps(profile_forward(engine))}")
            (ROOT / "build").mkdir(exist_ok=True)
            trace_dir = Path(tempfile.mkdtemp(prefix="trace_",
                                              dir=ROOT / "build"))
            chunk = torch.from_numpy(imgs).to(dev)
            with profiling.trace(str(trace_dir)):
                with profiling.annotate("ppf_int8_chunk"):
                    engine._forward(chunk)
                torch.cuda.synchronize()
            files = [f for f in trace_dir.iterdir()
                     if f.name.endswith(".json")]
            require(len(files) == 1, "profiling.trace wrote no trace file")
            text = files[0].read_text()
            log(f"profiling.trace: {files[0].name}, {len(text)} bytes, the "
                f"annotate span in it {'ppf_int8_chunk' in text}; device "
                "memory MiB " + json.dumps({
                    d: {k: round(v, 1) for k, v in s.items()
                        if k in ("allocated_bytes.all.peak",
                                 "reserved_bytes.all.current")}
                    for d, s in profiling.device_memory_stats().items()}))
            require("ppf_int8_chunk" in text,
                    "profiling.trace: the annotate span is missing")
    return results


def multi_phase(dev: torch.device, state_dict,
                rng: np.random.Generator) -> dict:
    """Phase 4k (see the module docstring)."""
    t0 = time.perf_counter()
    results = ddp_phase(dev)
    log(f"data-parallel training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    results.update(mesh_phase(dev, state_dict, rng))
    results.update(options_phase(dev, state_dict, rng))
    log(f"mesh engine, int8 and LayerNorm options: "
        f"{time.perf_counter() - t0:.1f} s")
    return results


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
    paths.update(thresh(dev, state_dict, rng)[0])
    log(f"thresh forward: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.update(bench(dev))
    log(f"kernel bench: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    card_vs_cpu(dev, state_dict, rng)
    log(f"card vs cpu: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cait_served = cait(dev, rng)
    log(f"cait: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = train_phase(dev)
    paths.update(trained)
    log(f"train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide, wide_records = width_phase(dev, rng, state_dict)
    paths.update(wide)
    records.update(wide_records)
    log(f"width, push, kernel-off, unpruned: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long, long_records = long_phase(dev, rng)
    paths.update(long)
    records.update(long_records)
    log(f"token counts above 256: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    past, past_records = past_640_phase(dev, rng)
    paths.update(past)
    records.update(past_records)
    log(f"token counts past 640: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fed = data_phase(dev)
    paths.update(fed)
    log(f"data layer: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.update(offline_phase(dev))
    log(f"offline user path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multi = multi_phase(dev, state_dict, rng)
    paths.update(multi)
    log(f"several cards and serving options: {time.perf_counter() - t0:.1f} s")

    # launches of each record's kernel on the paths that run it
    per_record_mode = {
        "fused_attention_block_stats[speed]": [
            "bf16_speed", "bf16_speed_plain", "int8_bf16_speed",
            "ln_mxu_bf16_speed", "ln_compute_bf16_speed"],
        "fused_attention_block_stats[exact]": ["bf16_exact", "train_eval",
                                               "cli_train", "cli_eval",
                                               "offline_serve"],
        "fused_attention_mean_padded[fp32,N=197]": ["fp32_parity",
                                                    "tools_fp32",
                                                    "mesh_fp32"],
        "fused_attention_mean_padded[bf16,N=82]": ["bf16_speed",
                                                   "bf16_exact",
                                                   "train_eval", "cli_train",
                                                   "cli_eval",
                                                   "offline_serve",
                                                   "bf16_speed_plain",
                                                   "int8_bf16_speed",
                                                   "ln_mxu_bf16_speed",
                                                   "ln_compute_bf16_speed"],
        "fused_map_stats[fp32]": ["fp32_parity", "tools_fp32", "mesh_fp32"],
        "fused_map_stats[fp32,B=128]": ["train_bf16", "train_fp32",
                                        "cli_train", *(
                                            f"ddp_{b}" for b, _ in
                                            ddp_case_devices())],
        "fused_attention_core[bf16,ones]": ["thresh_bf16_exact"],
        "fused_attention_core[fp32,policy]": ["thresh_fp32"],
        "fused_attention_core[bf16,bench]": ["bench"],
        "fused_attention_core_padded[bf16,bench]": ["bench"],
        "fused_attention_block_stats[speed,H=6]": ["deit_s_bf16_speed"],
        "fused_attention_block_stats[exact,H=6]": ["deit_s_bf16_exact",
                                                   "deit_s_push"],
        "fused_attention_mean_padded[bf16,N=82,H=6]": [
            "deit_s_bf16_speed", "deit_s_bf16_exact", "deit_s_push"],
        "fused_attention_mean_padded[fp32,N=197,H=6]": ["deit_s_fp32_parity"],
        "fused_map_stats[fp32,H=6 map]": ["deit_s_fp32_parity"],
        "fused_attention_block_stats[speed,H=12]": ["deit_b_bf16_speed"],
        "fused_attention_mean_padded[bf16,N=82,H=12]": ["deit_b_bf16_speed"],
        "fused_attention_mean_padded[fp32,N=197,H=12]": ["deit_b_fp32_parity"],
        "fused_map_stats[fp32,H=12 map]": ["deit_b_fp32_parity"],
        "fused_map_stats[bf16,speed]": ["off_bf16_speed_k2"],
        "fused_attention_block_stats[speed,H=12,N=577]": [
            "deit_b384_bf16_speed"],
        "fused_attention_block_stats[exact,H=12,N=577]": [
            "deit_b384_bf16_exact"],
        "fused_attention_mean_padded[fp32,N=577,H=12]": [
            "deit_b384_fp32_parity"],
        "fused_map_stats[fp32,H=12,N=577 map]": ["deit_b384_fp32_parity"],
        "fused_attention_core[bf16,N=577,H=12]": [
            "deit_b384_thresh_bf16_exact"],
        "fused_attention_core[fp32,N=577,H=12]": ["deit_b384_thresh_fp32"],
        "fused_attention_core_padded[bf16,bench,N=577]": ["bench_577"],
        "fused_attention_block_stats[speed,H=3,N=257]": [
            "deit_t_p2_bf16_speed"],
        "fused_attention_block_stats[exact,H=3,N=257]": [
            "deit_t_p2_bf16_exact"],
        "fused_attention_mean_padded[fp32,N=257,H=3]": [
            "deit_t_p2_fp32_parity"],
        "fused_map_stats[fp32,H=3,N=257 map]": ["deit_t_p2_fp32_parity"],
        "fused_attention_block_stats[speed,H=3,N=785]": [
            "deit_t448_bf16_speed"],
        "fused_attention_block_stats[exact,H=3,N=785]": [
            "deit_t448_bf16_exact"],
        "fused_attention_mean_padded[fp32,N=785,H=3]": [
            "deit_t448_fp32_parity"],
        "fused_map_stats[fp32,H=3,N=785 map]": ["deit_t448_fp32_parity"],
        "fused_attention_core[bf16,N=785,H=3]": [
            "deit_t448_thresh_bf16_exact"],
        "fused_attention_core[fp32,N=785,H=3]": ["deit_t448_thresh_fp32"],
        "fused_attention_core_padded[bf16,bench,N=785]": ["bench_785"],
        "fused_attention_block_stats[speed,H=3,N=1025]": [
            "deit_t512_bf16_speed"],
        "fused_attention_mean_padded[fp32,N=1025,H=3]": [
            "deit_t512_fp32_parity"],
        "fused_map_stats[fp32,H=3,N=1025 map]": ["deit_t512_fp32_parity"],
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
        {m: r["img_per_sec"] for m, r in {**served, **cait_served,
                                          **wide, **long}.items()
         if "img_per_sec" in r}))
    log("train img/s (B=128): " + json.dumps(
        {m: r["img_per_sec"] for m, r in {**trained, **fed}.items()
         if "img_per_sec" in r}))
    log("phase 4k img/s: " + json.dumps(
        {m: r["img_per_sec"] for m, r in multi.items()}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(sys.argv[2:]))
    sys.exit(main())
