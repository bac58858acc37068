"""K1's and K3's long kernels, timed against a parent commit's at the
models' own operands.

K1 and K3 launch their long kernels (``block_stats_long_kernel``,
``bf16k``/``f32k::mean_long_kernel``) from 257 tokens on
(``csrc/common.cuh``) and their short ones below. The comparison runs a
copy under ``build/long_kernels_parent/`` whose ``csrc/`` is DIR's (A;
DIR holds an unpacked tree of the parent commit, ``git archive HEAD | tar
-x -C DIR``), the Python being this checkout's, against the package (B),
each side in a process of its own that builds its own library, in the
order A, B, B, A, and reports the mean of each side's two readings.

Each side builds DeiT-B/16@384's and ``deit_tiny_patch2_32``'s PPNets at
the CUB preset from a seed and serves a chunk in each mode, capturing the
operands of the first K1, K2 and K3 calls (block 0's), holds the kernels
against their plain versions on them (K1: t equal to ``masked_map_stats``
on its own map, s within 1e-6, the map within one bf16 ulp and out within
two of their largest entries; K2: t bit-equal to ``map_stats_plain``, s
within 1e-6; K3: out within 1e-5 in fp32 or 1e-2 in bf16, the map within
1e-6) and times them: K1, K1's select alone (K2's launch on K1's stored
map), K2 on the fp32 serving map, K3 in fp32; the same for DeiT-Tiny/16 at
448 and 512 px (785 and 1,025 tokens, past 640: K1's head split, K3 fp32's
key split); K4 in fp32 on the 384 and 448 fp32 operands (its attention
phase is K3's kernel); the 384's and the 448's bf16 exact
``masked_forward_thresh`` at B=160: img/s, and K4 with its attention phase
(K3 bf16's long kernel) and its normalize on the first K4 call's operands;
K5 on the kernel bench's operands at 577 and 785 tokens (real 577 in NP
640, 785 in 896, B=256; held against the plain normalize of K3's map) with
its attention phase, and K3 bf16 on the bench's operands at 257; and the
routes at N <= 256 that share the select's code, on seeded random
operands: K1 in both modes and K2 on K1's exact map at 197 and 256 tokens,
and K5 on the bench's operands at 197 and 256 with its attention phase and
its normalize (the call less that phase).

B = 160 (a serving chunk) but for the bench's K5. Needs a CUDA card.

    python -m protopformer_tpu_torch.cli.time_long_kernels --parent build/parent
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "protopformer_tpu_torch"
PARENT_COPY = ROOT / "build" / "long_kernels_parent"
# the models of the comparison, by the record tag of their token
# count: a preset and its overrides (DeiT-Tiny/16 at 448 and 512 px)
MODELS = {"N=577": ("deit_base_patch16_384", {}),
          "N=257": ("deit_tiny_patch2_32", {}),
          "N=785": ("deit_tiny_patch16_224", {"img_size": 448}),
          "N=1025": ("deit_tiny_patch16_224", {"img_size": 512})}
MODES = ("bf16_speed", "bf16_exact", "fp32_parity")
# (N, C, H) of the short readings: DeiT-Tiny and
# DeiT-B's heads at 197, and the short route's largest N
SHORT_CASES = ((197, 192, 3), (197, 768, 12), (256, 192, 3))
B = 160


def _bf16_ulp(x: torch.Tensor) -> float:
    return math.ldexp(1.0, math.frexp(float(x.float().abs().max()))[1] - 8)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _hold_k1(name: str, qkv: torch.Tensor, heads: int, exact: bool):
    """K1 against its plain version on ``qkv``; returns the launch."""
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.ops.rollout import masked_map_stats

    n = qkv.shape[1]
    keep = n * n - int(n * n * 0.9)
    call = lambda: ac.fused_attention_block_stats(  # noqa: E731
        qkv, heads, 0.9, exact_discard=exact)
    out, fmap, t, s = call()
    p_out, p_map, _, _ = ac.block_stats_plain(qkv, heads, keep, exact)
    own_t, own_s = masked_map_stats(fmap, 0.9, exact_discard=exact)
    if not (torch.equal(t, own_t) and _max_err(s, own_s) <= 1e-6
            and _max_err(fmap, p_map) <= _bf16_ulp(p_map)
            and _max_err(out, p_out) <= 2 * _bf16_ulp(p_out)):
        raise AssertionError(f"{name}: differs from its plain version")
    return call


def _hold_k3(name: str, qkv: torch.Tensor, pol: torch.Tensor, heads: int,
             real_n: int = None):
    """K3 against its plain version on ``qkv`` (``real_n`` real tokens, all
    by default); returns the launch."""
    from protopformer_tpu_torch.kernels import attention_core as ac

    n = qkv.shape[1] if real_n is None else real_n
    tol = 1e-5 if qkv.dtype == torch.float32 else 1e-2
    call = lambda: ac.fused_attention_mean_padded(  # noqa: E731
        qkv, pol, heads, real_n=n)
    out, fmap = call()
    p_out, p_map = ac.mean_padded_plain(qkv, pol, heads, real_n=n)
    if not (_max_err(out, p_out) <= tol and _max_err(fmap, p_map) <= 1e-6):
        raise AssertionError(f"{name}: differs from its plain version")
    return call


def _hold_k2(name: str, fmap: torch.Tensor, exact: bool):
    """K2's launch on a stored map against ``map_stats_plain`` (t
    bit-equal, s within 1e-6); returns the launch."""
    from protopformer_tpu_torch.kernels import stats

    n = fmap.shape[1]
    call = lambda: stats.fused_map_stats(fmap, 0.9, exact)  # noqa: E731
    t, s = call()
    p_t, p_s = stats.map_stats_plain(fmap, n * n - int(n * n * 0.9),
                                     not exact)
    if not (torch.equal(t.float(), p_t) and _max_err(s, p_s) <= 1e-6):
        raise AssertionError(f"{name}: differs from its plain version")
    return call


def _hold_k5(name: str, qkv: torch.Tensor, pol: torch.Tensor, heads: int,
             real_n: int):
    """K5 against the plain normalize of K3's raw map on the same operands
    (the same entries kept, the map within 1e-6, the pads 0); returns the
    launch."""
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.ops.rollout import normalize_attention_map

    n = real_n
    call = lambda: ac.fused_attention_core_padded(  # noqa: E731
        qkv, pol, heads, n)
    _, fmap = call()
    _, raw = ac.fused_attention_mean_padded(qkv, pol, heads, n)
    want = normalize_attention_map(raw[:, :n, :n], 0.9, 0.2, True)
    eye = torch.eye(n, dtype=torch.bool, device=qkv.device)
    kept = lambda m: (m > 0) & ~eye  # noqa: E731
    if not (torch.equal(kept(fmap[:, :n, :n]), kept(want))
            and _max_err(fmap[:, :n, :n], want) <= 1e-6
            and float(fmap[:, n:].abs().sum() + fmap[:, :, n:].abs().sum())
            == 0.0):
        raise AssertionError(f"{name}: differs from the plain normalize")
    return call


@contextlib.contextmanager
def _first_calls(module, names):
    """Record the arguments of the first call of each ``module.<name>``
    (called through) in the dict it yields."""
    seen, saved = {}, {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            seen.setdefault(name, args)
            return fn(*args, **kwargs)
        return wrapped

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def worker(dev: torch.device = torch.device("cuda")) -> Dict[str, float]:
    """Serve each model of ``MODELS`` with the package on ``sys.path``;
    hold and time the long kernels on its operands. Returns ms per kernel
    record."""
    from protopformer_tpu_torch.cli.bench_kernels import _time_ms
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.models import construct_ppnet, deit, layers
    from protopformer_tpu_torch.serving import ServingEngine

    ppnet = PPNetConfig()
    res = {}
    for at, (preset, overrides) in MODELS.items():
        cfg = backbone_preset(preset, **overrides)
        heads = cfg.num_heads
        state_dict = construct_ppnet(
            cfg, ppnet, torch.float32,
            generator=torch.Generator().manual_seed(10)).state_dict()
        gen = torch.Generator().manual_seed(11)
        chunk = torch.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3),
                              generator=gen, dtype=torch.uint8).to(dev)
        for mode in MODES:
            backbone = (backbone_preset(preset, **overrides,
                                        rollout_exact_discard=False)
                        if mode == "bf16_speed" else cfg)
            dtype = torch.float32 if mode == "fp32_parity" else torch.bfloat16
            engine = ServingEngine(backbone, ppnet, state_dict, batch_size=B,
                                   compute_dtype=dtype, with_attn=True,
                                   device=dev)
            with _first_calls(layers, ("fused_attention_block_stats",
                                       "fused_attention_mean_padded")) as seen, \
                    _first_calls(deit, ("fused_map_stats",)) as seen_k2:
                engine._forward(chunk)
            torch.cuda.synchronize()
            if mode == "fp32_parity":
                qkv, pol = (a.clone() for a in
                            seen["fused_attention_mean_padded"][:2])
                name = f"K3[fp32,{at},H={heads}]"
                res[name] = _time_ms(_hold_k3(name, qkv, pol, heads), dev, 3,
                                     20)
                if at in ("N=577", "N=785"):
                    res[f"K4[fp32,{at},H={heads}]"] = _time_ms(
                        lambda: ac.fused_attention_core(qkv, pol, heads, 0.9,
                                                        0.2), dev, 3, 20)
                # K2 on the serving map (block 0's)
                fmap = seen_k2["fused_map_stats"][0].clone()
                name = f"K2[fp32,{at}]"
                res[name] = _time_ms(_hold_k2(name, fmap, True), dev, 3, 20)
                del qkv, pol, fmap
            else:
                qkv = seen["fused_attention_block_stats"][0].clone()
                exact = mode == "bf16_exact"
                name = f"K1[{mode[5:]},{at},H={heads}]"
                res[name] = _time_ms(_hold_k1(name, qkv, heads, exact), dev,
                                     3, 20)
                # K1's second launch alone: K2's select on K1's stored map
                # (the cap at 1.0 aside)
                _, fmap, _, _ = ac.fused_attention_block_stats(qkv, heads,
                                                               0.9, exact)
                name = f"K1_select[{mode[5:]},{at}]"
                res[name] = _time_ms(_hold_k2(name, fmap, exact), dev, 3, 20)
                del qkv, fmap
            del engine, seen, seen_k2
            torch.cuda.empty_cache()
        if at in ("N=577", "N=785"):
            res.update(thresh_readings(cfg, ppnet, state_dict, dev))
        del state_dict
    res.update(bench_readings(dev))
    res.update(short_readings(dev))
    return res


def thresh_readings(cfg, ppnet, state_dict, dev) -> Dict[str, float]:
    """The bf16 exact ``masked_forward_thresh`` of ``cfg``'s backbone at
    B=160 (K4 on blocks 0-10): its img/s (CUDA events over 5 forwards
    after 2), and K4's attention phase (K3 bf16's long kernel) and whole
    call on the first K4 call's operands."""
    from protopformer_tpu_torch.cli.bench_kernels import _time_ms
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.models import DeiTBackbone, layers

    at = f"N={cfg.num_patches + 1}"
    heads = cfg.num_heads
    model = DeiTBackbone(cfg, torch.bfloat16)
    model.load_state_dict({k[len("features."):]: v
                           for k, v in state_dict.items()
                           if k.startswith("features.")}, strict=True)
    model = model.to(dev).eval()
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((B, cfg.img_size, cfg.img_size, 3), generator=gen).to(dev)
    token_attn = (torch.rand((B, cfg.num_patches), generator=gen)
                  * (2.0 / cfg.num_patches)).to(dev)
    reserve = ppnet.reserve_layer_nums

    def forward():
        with torch.inference_mode():
            return model.masked_forward_thresh(*model.embed_all(x),
                                               token_attn, reserve)

    with _first_calls(layers, ("fused_attention_core",)) as seen:
        forward()
    qkv = seen["fused_attention_core"][0].clone()
    ones = torch.ones(qkv.shape[:2], device=dev)
    res = {}
    name = f"K3[bf16,thresh,{at},H={heads}]"
    attention = res[name] = _time_ms(_hold_k3(name, qkv, ones, heads), dev,
                                     3, 20)
    name = f"K4[bf16,thresh,{at},H={heads}]"
    res[name] = _time_ms(
        lambda: ac.fused_attention_core(qkv, None, heads, 0.9, 0.2,
                                        ones_policy=True), dev, 3, 20)
    res[f"K4_normalize[bf16,thresh,{at}]"] = res[name] - attention
    tag = "" if at == "N=577" else f",{at}"
    res[f"img_per_sec[thresh_bf16_exact{tag}]"] = B / (
        _time_ms(forward, dev, 2, 5) / 1e3)
    del model, qkv
    torch.cuda.empty_cache()
    return res


def bench_readings(dev) -> Dict[str, float]:
    """K5 on the kernel bench's operands at 577 and 785 tokens (real 577
    in NP 640, real 785 in NP 896, B=256): the whole call, its attention
    phase (K3 bf16's long kernel) and, at 785, its normalize (the call
    less that phase); and K3 bf16's long kernel at its least token count,
    on the bench's unpadded operands at 257."""
    from protopformer_tpu_torch.cli.bench_kernels import (
        H as BENCH_H, _time_ms, bench_inputs)

    res = {}
    for n in (577, 785):
        x = bench_inputs(dev, tokens=n)
        qkv, pol = x["qkv_pad"], x["policy_pad"]
        at = f"bench,{n} in {qkv.shape[1]}"
        name = f"K3[bf16,{at}]"
        attention = res[name] = _time_ms(_hold_k3(name, qkv, pol, BENCH_H, n),
                                         dev, 3, 20)
        name = f"K5[bf16,{at}]"
        res[name] = _time_ms(_hold_k5(name, qkv, pol, BENCH_H, n), dev, 3, 20)
        if n == 785:
            res[f"K5_normalize[{at}]"] = res[name] - attention
        del x, qkv, pol
    x = bench_inputs(dev, tokens=257)
    name = "K3[bf16,bench,257]"
    res[name] = _time_ms(_hold_k3(name, x["qkv"], x["policy"], BENCH_H),
                         dev, 3, 20)
    return res


def short_readings(dev) -> Dict[str, float]:
    """The routes at N <= 256 that share the select's code with the long
    one, on seeded random operands: K1 in both modes and K2 on K1's exact
    map at the ``SHORT_CASES``, and K5 on the kernel bench's operands at
    197 and 256 tokens (NP 256, B=256) with its attention phase (K3's
    call on the same operands) and its normalize (the call less that
    phase)."""
    from protopformer_tpu_torch.cli.bench_kernels import (
        H as BENCH_H, _time_ms, bench_inputs)
    from protopformer_tpu_torch.kernels import attention_core as ac

    gen = torch.Generator().manual_seed(13)
    res = {}
    for n, c, h in SHORT_CASES:
        qkv = torch.randn((B, n, 3 * c), generator=gen).to(dev,
                                                          torch.bfloat16)
        for exact in (False, True):
            name = f"K1[{'exact' if exact else 'speed'},N={n},H={h}]"
            res[name] = _time_ms(_hold_k1(name, qkv, h, exact), dev, 3, 20)
        _, fmap, _, _ = ac.fused_attention_block_stats(qkv, h, 0.9, True)
        name = f"K2[fp32,N={n},H={h}]"
        res[name] = _time_ms(_hold_k2(name, fmap, True), dev, 3, 20)
    for n in (197, 256):
        x = bench_inputs(dev, tokens=n)
        qkv, pol = x["qkv_pad"], x["policy_pad"]
        at = f"bench,{n} in {qkv.shape[1]}"
        name = f"K3[bf16,{at}]"
        attention = res[name] = _time_ms(
            _hold_k3(name, qkv, pol, BENCH_H, n), dev, 3, 20)
        name = f"K5[bf16,{at}]"
        res[name] = _time_ms(_hold_k5(name, qkv, pol, BENCH_H, n), dev, 3,
                             20)
        res[f"K5_normalize[{at}]"] = res[name] - attention
    return res


def _copy_package(dest: Path) -> Path:
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / PACKAGE, dest / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def make_parent(parent: Path) -> Path:
    """The package under ``PARENT_COPY`` with the kernel sources of the tree
    unpacked at ``parent``."""
    src = Path(parent) / PACKAGE / "csrc"
    if not src.is_dir():
        raise RuntimeError(f"{src}: no kernel sources of a parent tree")
    csrc = _copy_package(PARENT_COPY) / PACKAGE / "csrc"
    shutil.rmtree(csrc)
    shutil.copytree(src, csrc)
    return PARENT_COPY


def run(parent: Path) -> Dict[str, object]:
    if not torch.cuda.is_available():
        raise RuntimeError("time_long_kernels needs a CUDA card")
    roots = {"parent": make_parent(parent), "change": ROOT}
    a, b = roots
    readings = {a: [], b: []}
    for side in (a, b, b, a):
        proc = subprocess.run(
            [sys.executable, "-m", f"{PACKAGE}.cli.time_long_kernels",
             "--worker"], cwd=roots[side], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the {side} side failed:\n{proc.stderr}")
        readings[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    mean = {side: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
            for side, rs in readings.items()}
    values = {}
    for k in {**mean[a], **mean[b]}:
        values[k] = {side: mean[side][k] for side in (a, b)
                     if k in mean[side]}
        if len(values[k]) == 2:
            values[k][f"{b}_over_{a}"] = mean[b][k] / mean[a][k]
    return {"device": torch.cuda.get_device_name(0), "batch": B,
            "values": values, "readings": readings}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="an unpacked tree of the parent commit")
    parser.add_argument("--worker", action="store_true",
                        help="time the package on sys.path and print JSON")
    args = parser.parse_args(argv)
    if args.worker:
        out = worker()
    else:
        if args.parent is None:
            parser.error("--parent DIR is required")
        out = run(args.parent)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
