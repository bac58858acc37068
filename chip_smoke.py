#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``protopformer_tpu_torch``) on one GPU.

Run from anywhere, with the package beside this script, on a machine with a
CUDA card (an H100 is the target):

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernels from protopformer_tpu_torch/csrc (one nvcc per
     source, all started together) and print each kernel's ptxas report;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes (B=160; N=197, and N=82 after the prune-point gather),
     then timed with CUDA events beside its plain version and its bound;
  4. serving: one ServingEngine per mode (bf16 speed, bf16 exact, fp32
     parity) over seeded random DeiT-Tiny/16@224 weights with 2000 local
     and 2000 global prototypes answers requests of 1, 160 and 333 images;
     every kernel launch counter is set to 0 just before a mode's requests
     and read just after, and must show the launches that mode's forward
     makes; then throughput_probe at B=160 and a torch.profiler breakdown
     of one chunk's forward (device-busy time, idle share, top kernels);
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

import json
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


def bound(nbytes: float, flops: float, flops_peak: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --- phase 3: each kernel against its plain version ---------------------------

def check_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Returns {entry name: partial kernel record} for the kernels line."""
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.kernels import stats
    from protopformer_tpu_torch.ops.rollout import masked_map_stats

    records = {}
    E = N * N
    keep = E - int(E * DISCARD)

    # K1 on a bf16 (B, N, 3C) qkv, both map storage modes. The kernel rounds
    # where the plain version does, so its map and t must equal the plain
    # version's bit for bit; out may differ by one bf16 ulp where cuBLAS
    # sums the fp32 products of probs @ v in another order.
    qkv = torch.randn((B, N, 3 * C), generator=gen).to(dev, torch.bfloat16)
    for exact in (False, True):
        mode = "exact" if exact else "speed"
        out, fmap, t, s = ac.fused_attention_block_stats(qkv, H, DISCARD, exact)
        p_out, p_map, p_t, p_s = ac.block_stats_plain(qkv, H, keep, exact)
        own_t, _ = masked_map_stats(fmap, DISCARD, exact_discard=exact)
        torch.cuda.synchronize()
        require(torch.equal(fmap, p_map),
                f"K1 {mode}: map differs from the plain version")
        require(torch.equal(t, p_t.to(t.dtype)),
                f"K1 {mode}: t differs from the plain version")
        require(torch.equal(t, own_t),
                f"K1 {mode}: t differs from masked_map_stats on its own map")
        out_tol = 2.0 ** -8 * float(p_out.float().abs().max())
        errs = {"s": max_err(s, p_s), "map": max_err(fmap, p_map),
                "out": max_err(out, p_out)}
        log(f"K1 {mode}: map and t bit-equal; max abs err {json.dumps(errs)} "
            f"(tolerance s 1e-6, out one bf16 ulp of max|out| = {out_tol!r})")
        require(errs["s"] <= 1e-6 and errs["out"] <= out_tol,
                f"K1 {mode}: outside tolerance")
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
            bound=bound(nbytes, 4.0 * B * N * N * C, BF16_FLOPS),
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
            bound=bound(nbytes, 4.0 * B * n * n * C, peak),
        )

    # K2 on the fp32 head-mean maps K3 just emitted (the parity path)
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
        # 31 counting passes and the masked row sums, one operation each
        bound=bound(nbytes, 32.0 * B * E, FP32_FLOPS),
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
    if mode.startswith("bf16"):
        return {"fused_attention_block_stats": pre * chunks,
                "fused_map_stats": 0,
                "fused_attention_mean_padded": chunks}
    return {"fused_attention_block_stats": 0,
            "fused_map_stats": pre * chunks,
            "fused_attention_mean_padded": depth * chunks}


def profile_forward(engine, reps: int = 3, top: int = 8) -> dict:
    """Where one chunk's forward spends its time: its host-clock time, and
    from a torch.profiler trace of ``reps`` forwards the device-busy time
    (the union of the kernels' intervals), the idle share of the traced
    window and the largest kernels by device time, all per chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    chunk = torch.zeros((engine.batch_size, 224, 224, 3), dtype=torch.uint8,
                        device=engine.device)
    engine.warmup()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine._forward(chunk)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine._forward(chunk)
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
    fp32_order = np.argsort(-cpu.cls_token_attn, axis=-1)
    atol = 2e-2 * float(np.abs(cpu.logits).max())
    for mode in ("bf16_speed", "bf16_exact"):
        bf16 = run(modes[mode][0], torch.bfloat16, dev)
        overlap, worst_drop = [], []
        for b, got in enumerate(top81(bf16.cls_token_attn)):
            want = set(fp32_order[b, :81].tolist())
            rank = {int(tok): r for r, tok in enumerate(fp32_order[b])}
            overlap.append(len(want & got))
            worst_drop.append(min((rank[t] for t in want - got), default=None))
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

    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    records = check_kernels(dev, gen)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    ppnet, modes = model_configs()
    model = construct_ppnet(modes["fp32_parity"][0], ppnet, torch.float32,
                            generator=torch.Generator().manual_seed(1))
    state_dict = model.state_dict()
    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    served = serve(dev, state_dict, rng)
    log(f"serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    card_vs_cpu(dev, state_dict, rng)
    log(f"card vs cpu: {time.perf_counter() - t0:.1f} s")

    # launches of each record's kernel in the mode whose path runs it
    per_record_mode = {
        "fused_attention_block_stats[speed]": ["bf16_speed"],
        "fused_attention_block_stats[exact]": ["bf16_exact"],
        "fused_attention_mean_padded[fp32,N=197]": ["fp32_parity"],
        "fused_attention_mean_padded[bf16,N=82]": ["bf16_speed",
                                                   "bf16_exact"],
        "fused_map_stats[fp32]": ["fp32_parity"],
    }
    line = []
    for name, rec in records.items():
        launches = sum(served[m]["launches"][rec["kernel"]]
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
