"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process, one cell, one run: set up,
measure for ``--seconds``, (traced run: profile a short slice after the
window), read the device's peak memory, free the program, check the
outputs against the plain reference, and print one JSON line last on
standard output. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics. Each compared number and its limit
are the last lines on standard error and the result line's last key.

``setup_s`` runs from the start of the process to the start of the
window. The run needs as many CUDA cards as the cell names and exits with
another code than 0, printing no result, where they are missing, or where
the process holds JAX or the JAX package when the result is due: the look
comes last, after the check and the per-layer readers, so that it covers
whatever they load.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

from benchmark import harness, trace

START = harness.process_start()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(chips: int):
    """The run's device; raises where CUDA or the cell's cards are
    missing. There is no CPU fallback."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} CUDA cards, "
                           f"{torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def per_layer_record(cell: harness.Cell, window: dict, slice_: dict
                     ) -> dict:
    """What the per-layer readers read: the cell's configuration, the
    window's counts and spans, and the traced slice."""
    return {"config": cell.config, "window": window["record"],
            "slice": slice_}


def run(args: argparse.Namespace, root: Path, device=None) -> int:
    spec = harness.read_json(root / "BENCHMARK.json")
    cell = harness.find_cell(spec, args.workload, root)
    if device is None:
        device = require_cards(cell.chips)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          device=device)
    driver = cell.driver().Driver(ctx)
    driver.setup()
    setup_s = time.perf_counter() - START
    window = driver.window()
    t_trace = time.perf_counter()
    slice_ = driver.trace() if args.trace else None
    t_check = time.perf_counter()
    dev_record = harness.device_record(device, cell.chips)
    driver.release()
    numbers = driver.check()
    print(f"setup {setup_s:.1f} s, window {window['record']['window_s']:.1f}"
          f" s, trace {t_check - t_trace:.1f} s, check "
          f"{time.perf_counter() - t_check:.1f} s; {window['attempted']} "
          f"attempted; latency or step quartiles (ms) "
          f"{[round(q * 1e3, 2) for q in window['quartiles_s']]}",
          file=sys.stderr)
    missing = sorted(set(numbers) - set(cell.limits))
    if missing:
        raise KeyError(f"no limit for {missing} in limits/{cell.name}.json")

    if args.trace:
        metrics = harness.read_per_layer(
            cell, per_layer_record(cell, window, slice_))
        dev_record["busy_s"] = slice_["busy_s"]
        dev_record["window_s"] = slice_["window_s"]
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = (window["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": dev_record}
    if args.trace:
        result["breakdown"] = trace.breakdown(slice_)
    result["checks"] = checks
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print("the process holds JAX or the JAX package: "
              + ", ".join(forbidden), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, root: Optional[Path] = None, device=None) -> int:
    return run(parse_args(argv), root or harness.ROOT, device)


if __name__ == "__main__":
    sys.exit(main())
