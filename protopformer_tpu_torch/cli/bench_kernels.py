"""Kernel bench: attention plus rollout-map normalize, per block, three ways.

The port's counterpart of ``scripts/bench_kernels.py``. At B=256, N=197
(NP=256 for K5), C=192, H=3 in bf16 it prints the time of one block of:

  * the plain PyTorch path (``core_plain``: attention, then the normalize);
  * K4, ``fused_attention_core``, at N=197;
  * K5, ``fused_attention_core_padded``, on operands padded to NP=256.

    python -m protopformer_tpu_torch.cli.bench_kernels [--device cpu] [--batch B]

On the card each time is the mean over ``--iters`` calls between two CUDA
events, after ``--warmup`` calls. With ``--device cpu`` the kernel
functions run their plain versions and the host clock times them; those
are CPU times, not kernel times. The JAX script's sweep over
``block_batch`` (samples per TPU grid step) has no counterpart: a CUDA
block takes one sample, or one row tile of one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import torch

from protopformer_tpu_torch.kernels import attention_core as ac

N, NP, C, H = 197, 256, 192, 3


def _time_ms(fn: Callable[[], object], dev: torch.device, warmup: int,
             iters: int) -> float:
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench_inputs(device="cuda", batch: int = 256, seed: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """The bench's seeded bf16 operands on ``device``: ``qkv`` (batch, N, 3C)
    with its all-ones ``policy`` (batch, N), and both zero-padded to NP as
    ``qkv_pad`` and ``policy_pad``."""
    gen = torch.Generator().manual_seed(seed)
    qkv = (torch.randn((batch, N, 3 * C), generator=gen) * 0.5).to(
        device, torch.bfloat16)
    pol = torch.ones((batch, N), device=device)
    return {"qkv": qkv, "policy": pol,
            "qkv_pad": torch.nn.functional.pad(qkv, (0, 0, 0, NP - N)),
            "policy_pad": torch.nn.functional.pad(pol, (0, NP - N))}


def run(device="cuda", batch: int = 256, iters: int = 20, warmup: int = 3,
        seed: int = 0) -> Dict[str, object]:
    """Time the three paths on ``device`` (CUDA unless asked for the CPU),
    on ``bench_inputs(device, batch, seed)``.

    Returns {"device", "batch", "n", "np", "ms_per_block": {"plain",
    "fused_attention_core", "fused_attention_core_padded"}}.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bench_kernels runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to time the plain versions"
        )
    x = bench_inputs(dev, batch, seed)
    paths = {
        "plain": lambda: ac.core_plain(x["qkv"], x["policy"], H),
        "fused_attention_core": lambda: ac.fused_attention_core(
            x["qkv"], x["policy"], H),
        "fused_attention_core_padded": lambda: ac.fused_attention_core_padded(
            x["qkv_pad"], x["policy_pad"], H, N),
    }
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "batch": batch, "n": N, "np": NP,
        "ms_per_block": {name: _time_ms(fn, dev, warmup, iters)
                         for name, fn in paths.items()},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    args = parser.parse_args(argv)
    res = run(args.device, args.batch, args.iters, args.warmup)
    ms = res["ms_per_block"]
    print(f"device {res['device']}, B={res['batch']}, bf16")
    print(f"plain attention+normalize:      {ms['plain']:9.3f} ms/block")
    print(f"K4 core (N={N}):               "
          f"{ms['fused_attention_core']:9.3f} ms/block")
    print(f"K5 padded core (NP={NP}):       "
          f"{ms['fused_attention_core_padded']:9.3f} ms/block")
    print("(no block_batch sweep: a CUDA block takes one sample)")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
