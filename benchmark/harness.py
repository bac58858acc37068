"""What every run shares: the benchmark's files found by name, the run's
context, the program's configuration objects built from a configuration
file, the device record, and the per-layer metrics' readers.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs[].file``) and a traffic mix (``benchmark/traffic/<mix>.json``);
the mix names its driver (``benchmark/drivers/<driver>.py``); each
per-layer metric is read by ``benchmark/metrics/<metric>.py``; each cell's
limits on its compared numbers are ``benchmark/limits/<cell>.json``. A new
cell, mix, driver or metric is new files and entries: nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "protopformer_tpu")


def process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (from
    ``/proc``, to 10 ms), or now where ``/proc`` has no record."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def load_module(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path (metric files carry dots
    in their names)."""
    name = "benchmark_file_" + "".join(
        ch if ch.isalnum() else "_" for ch in f"{path.parent.name}/{path.name}")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    def driver(self) -> ModuleType:
        return load_module(self.root / "benchmark" / "drivers"
                           / f"{self.traffic['driver']}.py")


def reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``,
    or, without that key, every cell (an end-to-end metric) or every cell
    that reports the metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``spec`` (``BENCHMARK.json``) with the files
    it names under ``root``."""
    bench = root / "benchmark"
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config_file = {c["name"]: c["file"] for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if reports(m, name, [])]
    names = [m["name"] for m in e2e]
    limits = bench / "limits" / f"{name}.json"
    return Cell(
        root=root, name=name, chips=int(w["chips"]),
        config=read_json(root / config_file),
        traffic=read_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(limits) if limits.exists() else {},
        end_to_end=e2e,
        per_layer=[m for m in spec["per_layer"] if reports(m, name, names)],
    )


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's seed and length, and the
    device."""

    cell: Cell
    seed: int
    seconds: float
    device: torch.device


def synchronize(device: torch.device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- the program's configuration objects -------------------------------------

def model_cfg(config: dict, mode: str) -> dict:
    """A configuration file's sizes flattened for ``mode`` ("serve" or
    "train"): its backbone and head with the mode's rollout settings."""
    out = dict(config["backbone"])
    out.update(config["head"])
    out.update(config[mode]["rollout"])
    return out


def port_configs(config: dict, mode: str):
    """(BackboneConfig, PPNetConfig, compute dtype) of the program for a
    configuration file's ``mode``: the preset with every size the file
    states, so the file and not the preset decides them."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset

    bk = {k: v for k, v in config["backbone"].items() if k != "preset"}
    bk.update(config[mode]["rollout"])
    backbone = backbone_preset(config["backbone"]["preset"], **bk)
    h = config["head"]
    ppnet = PPNetConfig(
        prototype_shape=(h["num_prototypes"], h["proto_dim"], 1, 1),
        num_classes=h["num_classes"],
        reserve_layers=tuple(h["reserve_layers"]),
        reserve_token_nums=tuple(h["reserve_token_nums"]),
        use_global=h["use_global"], global_coe=h["global_coe"],
        global_proto_per_class=h["global_proto_per_class"],
        prototype_activation_function=h["prototype_activation_function"],
        add_on_layers_type=h["add_on_layers_type"], epsilon=h["epsilon"],
        incorrect_class_connection=h["incorrect_class_connection"],
        use_ppc_loss=h["use_ppc_loss"], ppc_cov_thresh=h["ppc_cov_thresh"],
        ppc_mean_thresh=h["ppc_mean_thresh"],
        ppc_start_epoch=h["ppc_start_epoch"], ppc_cov_coe=h["ppc_cov_coe"],
        ppc_mean_coe=h["ppc_mean_coe"],
    )
    dtype = getattr(torch, config[mode]["compute_dtype"])
    return backbone, ppnet, dtype


# --- the device --------------------------------------------------------------

def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it (the first card),
    or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def device_record(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips)),
            "power_limit": power_limit()}


def loaded_forbidden() -> List[str]:
    """Modules of JAX or of the JAX package this process holds, compared by
    whole top-level names (the port's name begins with the JAX
    package's)."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def quartiles(values: List[float]) -> List[float]:
    """The three quartiles (``statistics.quantiles``), or the one value
    three times."""
    import statistics

    return (statistics.quantiles(values, n=4) if len(values) > 1
            else list(values) * 3)


# --- per-layer metrics -------------------------------------------------------

def read_per_layer(cell: Cell, record: dict) -> Dict[str, dict]:
    """Each of the cell's per-layer metrics read from the traced run's
    record; a reader that finds nothing to read returns None and its metric
    is left out."""
    out = {}
    for m in cell.per_layer:
        path = cell.root / "benchmark" / "metrics" / f"{m['name']}.py"
        value = load_module(path).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
