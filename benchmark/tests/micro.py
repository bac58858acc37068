"""A micro copy of the benchmark for the CPU tests: ``BENCHMARK.json`` and
the benchmark's data files in a temporary root, with one configuration at
``deit_micro_test``'s widths (24 wide, 2 heads, 64 px in patches of 8: 65
tokens) and micro mixes beside the real ones, so that the real drivers,
readers and reference run on it."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

MICRO = {
    "source": "micro test model (the DeiT layout at 24 wide)",
    "backbone": {"preset": "deit_micro_test", "img_size": 64, "patch_size": 8,
                 "in_chans": 3, "embed_dim": 24, "depth": 4, "num_heads": 2,
                 "mlp_ratio": 4.0, "qkv_bias": True, "layer_norm_eps": 1e-6,
                 "drop_rate": 0.0, "drop_path_rate": 0.1,
                 "rollout_discard_ratio": 0.9,
                 "rollout_identity_weight": 0.2},
    "head": {"num_prototypes": 8, "proto_dim": 16, "num_classes": 4,
             "global_proto_per_class": 2, "reserve_layers": [3],
             "reserve_token_nums": [16], "use_global": True,
             "global_coe": 0.5, "prototype_activation_function": "log",
             "add_on_layers_type": "regular", "epsilon": 1e-4,
             "incorrect_class_connection": -0.5, "use_ppc_loss": True,
             "ppc_cov_thresh": 1.0, "ppc_mean_thresh": 2.0,
             "ppc_cov_coe": 0.1, "ppc_mean_coe": 0.5, "ppc_start_epoch": 20},
    "serve": {"compute_dtype": "bfloat16", "batch_size": 8,
              "reference_rows": 8,
              "rollout": {"rollout_exact_discard": False}},
    "train": {"compute_dtype": "bfloat16",
              "rollout": {"rollout_exact_discard": True}},
    "assumed": [], "reduced": [],
}
MIXES = {
    "micro_bulk": {"driver": "serve", "sizes": [24, 24], "pool_images": 48,
                   "with_attn": False, "check_images": 24,
                   "trace_requests": 1},
    "micro_small": {"driver": "serve", "sizes": [1, 6], "pool_images": 16,
                    "with_attn": True, "check_images": 12,
                    "trace_requests": 2},
    "micro_train": {"driver": "train", "batch_size": 8, "pool_batches": 4,
                    "checked_steps": 3, "trace_steps": 2},
}
CELLS = {"micro.bulk": "micro_bulk", "micro.small": "micro_small",
         "micro.train": "micro_train"}


# The entries of the latency and training cells: their files are in the
# benchmark, and a cell that uses them is added by entries alone.
def _entries(cell, e2e, unit, better, per_layer):
    return {
        "end_to_end": [{"name": e2e, "unit": unit, "better": better,
                        "bound": 0.25, "source": "host_clock",
                        "workloads": [cell]}],
        "per_layer": [{"name": name, "unit": unit_, "better": better_,
                       "source": source, "layer": layer, "moves": e2e,
                       "workloads": [cell]}
                      for name, unit_, better_, source, layer in per_layer],
    }


OUT_ENTRIES = [
    _entries("micro.small", "serve_p95_ms", "ms", "lower", (
        ("device_idle.serve_small", "%", "lower", "device_trace", "device"),
        ("mfu.serve_small", "%", "higher", "host_clock", "models"))),
    _entries("micro.train", "train_img_per_s", "img/s", "higher", (
        ("device_idle.train", "%", "lower", "device_trace", "device"),
        ("mfu.train", "%", "higher", "host_clock", "models"),
        ("step_dispatch_ms.train", "ms", "lower", "program_span",
         "train"))),
]
LIMITS = {"logit_err": 1.0, "attn_err": 1.0, "grad_gap": 1.0,
          "change_gap": 1.0}


def build(tmp: Path, limits: dict = None) -> Path:
    """A root under ``tmp`` with the real benchmark's files and the micro
    configuration, mixes and cells added; returns the root."""
    root = tmp / "root"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    config = json.loads(json.dumps(MICRO))
    config["train"]["optim"] = harness.read_json(
        harness.BENCH / "configs" / "deit_tiny224_cub.json")["train"]["optim"]
    (root / "benchmark" / "configs" / "micro.json").write_text(
        json.dumps(config))
    spec["configs"].append({"name": "micro", "source": MICRO["source"],
                            "file": "benchmark/configs/micro.json",
                            "reduced": [], "why": "CPU tests"})
    for name, mix in MIXES.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for cell, mix in CELLS.items():
        spec["workloads"].append({"name": cell, "config": "micro",
                                  "traffic": mix, "chips": 1,
                                  "why": "CPU tests"})
        (root / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits or LIMITS))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" not in m:
            continue
        real = m["workloads"][0]
        kind = ("train" if real.endswith(".train") else "small"
                if real.endswith("serve_small") else "bulk")
        m["workloads"] = m["workloads"] + [f"micro.{kind}"]
    for out in OUT_ENTRIES:
        for key, entries in out.items():
            spec[key] += [e for e in entries
                          if e["name"] not in {m["name"] for m in spec[key]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
