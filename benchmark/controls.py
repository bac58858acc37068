"""Readings for the limits on a cell's compared numbers, on the card:

    python3 -m benchmark.controls --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--seconds 2]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the numbers ``correct`` compares (the program's
readings). For the first ``--control-seeds`` seeds also the control's
readings: the plain reference computed with fp8 products (e4m3 operands,
e5m2 gradients), in the program's place, against the float32 reference;
for a serving cell also the program's own int8 path (``quantize="int8"``)
on the same requests and the readings that are recorded and not compared
(``compare.serve_readings``), and where the mix asks for the rollout
scores a fault: the program's scores of each request handed to the image
before it (``scores_of_another_image``); for a training cell the reference with half
of each batch left out (the mean over the rest) and with its state left
unchanged. One JSON line a seed. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict

import numpy as np
import torch

from benchmark import compare, harness, run
from benchmark.reference import ppnet as reference
from benchmark.reference import train as reference_train


def serve_controls(driver) -> Dict[str, Dict[str, float]]:
    from protopformer_tpu_torch.serving import ServingEngine

    cell = driver.ctx.cell
    rows = cell.config["serve"]["reference_rows"]
    backbone, ppnet, dtype = harness.port_configs(cell.config, "serve")
    int8 = ServingEngine(dataclasses.replace(backbone, quantize="int8"),
                         ppnet, driver.sd, batch_size=driver.batch,
                         compute_dtype=dtype, with_attn=True,
                         device=driver.ctx.device)
    out: Dict[str, Dict[str, float]] = {}
    for offset, size, res in driver.sample():
        imgs = driver.pool[offset:offset + size]
        dev_imgs = torch.from_numpy(imgs).to(driver.ctx.device)
        ref = reference.serve_logits(driver.sd, driver.cfg, dev_imgs, rows)
        low = reference.serve_logits(driver.sd, driver.cfg, dev_imgs, rows,
                                     cast=reference.fp8_e4m3)
        quant = int8(imgs)
        runs = [("program", res.logits, res.cls_token_attn),
                ("fp8_reference", low["logits"].cpu().numpy(),
                 low["cls_token_attn"].cpu().numpy()),
                ("int8", quant.logits, quant.cls_token_attn)]
        if res.cls_token_attn is not None and size > 1:
            runs.append(("scores_of_another_image", res.logits,
                         np.roll(res.cls_token_attn, 1, axis=0)))
        for name, logits, attn in runs:
            nums = compare.serve_numbers(
                logits, ref["logits"], attn,
                None if attn is None else ref["cls_token_attn"])
            nums.update(compare.serve_readings(logits, ref["logits"]))
            for k, v in nums.items():
                out.setdefault(name, {})
                out[name][k] = max(out[name].get(k, v), v)
    return out


def train_controls(driver) -> Dict[str, Dict[str, float]]:
    n = driver.traffic["checked_steps"]
    batches = [(b["image"], b["label"]) for b in driver.pool[:n]]

    def steps(rows=None, cast=reference.keep_fp32):
        return reference_train.train_steps(
            driver.sd, driver.cfg, driver.optim,
            [(x[:rows], y[:rows]) for x, y in batches],
            driver._drop_path_generator(), cast)

    full = steps()
    out = {"program_loss": compare.train_readings(driver.losses, full)}
    half = batches[0][0].shape[0] // 2
    for name, run_ in (("fp8_reference", steps(cast=reference.fp8_e4m3)),
                       ("half_batch", steps(rows=half))):
        out[name] = compare.train_numbers(run_["grads"], run_["params"],
                                          full, driver.sd)
        out[name].update(compare.train_readings(run_["losses"], full))
    out["unchanged_state"] = unchanged(driver, batches, full)
    return out


def unchanged(driver, batches, full) -> Dict[str, float]:
    """The reference whose steps leave the state as it was: each step's
    loss at the first weights, no first moment (a gradient of nought) and
    no change."""
    gen = driver._drop_path_generator()
    with reference.fp32_matmuls():
        losses = [float(reference_train.loss_fn(
            driver.sd, driver.cfg, batch, gen, reference.keep_fp32))
            for batch in batches]
    zeros = {k: torch.zeros_like(g) for k, g in full["grads"].items()}
    out = compare.train_numbers(zeros, {k: driver.sd[k] for k in zeros},
                                full, driver.sd)
    out.update(compare.train_readings(losses, full))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, args.workload)
    device = run.require_cards(cell.chips)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds,
                              device=device)
        driver = cell.driver().Driver(ctx)
        driver.setup()
        driver.window()
        driver.release()
        line = {"workload": cell.name, "seed": seed,
                "program": driver.check()}
        if i < args.control_seeds:
            controls = (train_controls if cell.traffic["driver"] == "train"
                        else serve_controls)
            line["controls"] = controls(driver)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
