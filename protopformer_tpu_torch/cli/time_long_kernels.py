"""K1's and K3's long kernels against their short ones at N <= 256.

K1 and K3 launch their long kernels (``block_stats_long_kernel``,
``bf16k``/``f32k::mean_long_kernel``) from ``kLongMinTokens`` = 257 tokens
on (``csrc/common.cuh``) and their short ones below. This times both at
the short kernels' token counts: it copies the package to
``build/long_kernels/`` with ``kLongMinTokens`` set to 1, so that every N
takes the long kernels, and runs the same cases in the package and in the
copy, each in a process of its own that builds its own library, in the
order package, copy, copy, package. Every case is first held against its
plain version (K1: t equal to ``masked_map_stats`` on its own map, s
within 1e-6, the map within one bf16 ulp and out within two of their
largest entries; K3: out within 1e-5 in fp32 or 1e-2 in bf16, the map
within 1e-6). N = 257 takes the long kernels in both and is the control.
B = 160 (a serving chunk). Needs a CUDA card.

    python -m protopformer_tpu_torch.cli.time_long_kernels
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parents[2]
COPY = ROOT / "build" / "long_kernels"
THRESHOLD = "constexpr int kLongMinTokens = 257;"
# (N, C, H): DeiT-Tiny at 197 tokens and after the gather (82), DeiT-B's
# heads at 197, and the control at 257
CASES = ((197, 192, 3), (82, 192, 3), (197, 768, 12), (257, 192, 3))
B = 160


def _bf16_ulp(x: torch.Tensor) -> float:
    return math.ldexp(1.0, math.frexp(float(x.float().abs().max()))[1] - 8)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def worker() -> Dict[str, float]:
    """Hold and time every case with the package on ``sys.path``."""
    from protopformer_tpu_torch.cli.bench_kernels import _time_ms
    from protopformer_tpu_torch.kernels import attention_core as ac
    from protopformer_tpu_torch.ops.rollout import masked_map_stats

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    ms = {}
    for n, c, h in CASES:
        qb = torch.randn((B, n, 3 * c), generator=gen).to(dev, torch.bfloat16)
        q32 = torch.randn((B, n, 3 * c), generator=gen).to(dev)
        pol = (torch.rand((B, n), generator=gen) > 0.3).float()
        pol[:, 0] = 1.0
        pol = pol.to(dev)
        keep = n * n - int(n * n * 0.9)
        for exact in (False, True):
            name = f"K1[{'exact' if exact else 'speed'},N={n},H={h}]"
            call = lambda: ac.fused_attention_block_stats(  # noqa: E731
                qb, h, 0.9, exact_discard=exact)
            out, fmap, t, s = call()
            p_out, p_map, _, _ = ac.block_stats_plain(qb, h, keep, exact)
            own_t, own_s = masked_map_stats(fmap, 0.9, exact_discard=exact)
            if not (torch.equal(t, own_t) and _max_err(s, own_s) <= 1e-6
                    and _max_err(fmap, p_map) <= _bf16_ulp(p_map)
                    and _max_err(out, p_out) <= 2 * _bf16_ulp(p_out)):
                raise AssertionError(f"{name}: differs from its plain version")
            ms[name] = _time_ms(call, dev, 3, 20)
        for q, tag, tol in ((q32, "fp32", 1e-5), (qb, "bf16", 1e-2)):
            name = f"K3[{tag},N={n},H={h}]"
            call = lambda: ac.fused_attention_mean_padded(  # noqa: E731
                q, pol, h, real_n=n)
            out, fmap = call()
            p_out, p_map = ac.mean_padded_plain(q, pol, h, real_n=n)
            if not (_max_err(out, p_out) <= tol
                    and _max_err(fmap, p_map) <= 1e-6):
                raise AssertionError(f"{name}: differs from its plain version")
            ms[name] = _time_ms(call, dev, 3, 20)
    return ms


def make_copy() -> Path:
    """The package under ``COPY`` with every N taking the long kernels."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "protopformer_tpu_torch",
                    COPY / "protopformer_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = COPY / "protopformer_tpu_torch" / "csrc" / "common.cuh"
    text = header.read_text()
    if THRESHOLD not in text:
        raise RuntimeError(f"{header}: no line {THRESHOLD!r} to change")
    header.write_text(text.replace(THRESHOLD,
                                   "constexpr int kLongMinTokens = 1;"))
    return COPY


def run() -> Dict[str, object]:
    if not torch.cuda.is_available():
        raise RuntimeError("time_long_kernels needs a CUDA card")
    roots = {"short": ROOT, "long": make_copy()}
    readings = {"short": [], "long": []}
    for side in ("short", "long", "long", "short"):
        proc = subprocess.run(
            [sys.executable, "-m", "protopformer_tpu_torch.cli.time_long_kernels",
             "--worker"], cwd=roots[side], check=True, capture_output=True,
            text=True)
        readings[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    mean = {side: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
            for side, rs in readings.items()}
    return {"device": torch.cuda.get_device_name(0), "batch": B,
            "ms": {k: {"short": mean["short"][k], "long": mean["long"][k],
                       "long_over_short": mean["long"][k] / mean["short"][k]}
                   for k in mean["short"]},
            "readings": readings}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--worker", action="store_true",
                        help="time the package on sys.path and print JSON")
    args = parser.parse_args(argv)
    print(json.dumps(worker() if args.worker else run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
