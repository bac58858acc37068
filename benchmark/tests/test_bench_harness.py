"""The harness is data: a configuration, a traffic mix and a per-layer
metric added as new files and entries run without an edit to any file
there is; the traffic generator, the trace reduction and the readers; and
each fault a cell can have, planted under a run, turns ``correct``
false."""

import hashlib
import io
import itertools
import json
import subprocess
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch

from benchmark import arrivals, harness, run, trace
from benchmark.tests import micro

FP32_LIMITS = {"logit_err": 1e-2, "attn_err": 1e-2, "grad_gap": 1e-2,
               "change_gap": 1e-2}


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


_EXTENDED = """
import json, sys, torch
from pathlib import Path
from benchmark import run
out = []
for cell in ("micro.bulk", "micro.small", "micro.train"):
    run.main(["--workload", cell, "--seed", "3", "--seconds", "0.2",
              "--trace", "1"], root=Path.cwd(), device=torch.device("cpu"))
"""


def test_new_files_and_entries_extend_the_benchmark(tmp_path):
    root = micro.build(tmp_path)
    bench = root / "benchmark"
    (bench / "metrics" / "requests_in_window.micro.py").write_text(
        "def read(record):\n    return record['window'].get('requests')\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "requests_in_window.micro", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "serving",
        "moves": "serve_img_per_s", "workloads": ["micro.bulk",
                                                  "micro.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    for path in harness.BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = bench / path.relative_to(harness.BENCH)
            assert digest(copy) == digest(path), copy
    real = harness.read_json(harness.ROOT / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for i, entry in enumerate(real[key]):
            if "workloads" in entry:
                assert spec[key][i]["workloads"][:len(entry["workloads"])] \
                    == entry["workloads"]
            else:
                assert spec[key][i] == entry

    out = subprocess.run(
        [sys.executable, "-c", _EXTENDED], cwd=root, capture_output=True,
        text=True, timeout=600, check=True,
        env={"PYTHONPATH": str(harness.ROOT), "PATH": "/usr/bin:/bin"},
    ).stdout.strip().splitlines()
    bulk, small, train = (json.loads(line) for line in out[-3:])
    assert bulk["metrics"]["requests_in_window.micro"]["value"] >= 1
    assert "mfu.serve_bulk" in bulk["metrics"]
    assert "mfu.serve_small" in small["metrics"]
    # the train driver's window counts steps, not requests: nothing to read
    assert "requests_in_window.micro" not in train["metrics"]
    assert "step_dispatch_ms.train" in train["metrics"]


def test_every_seed_sends_the_same_sizes():
    mix = {"sizes": [1, 32], "pool_images": 64}
    cycles = {}
    for seed in (1, 2 ** 31 + 11):
        reqs = list(itertools.islice(arrivals.requests(mix, seed), 96))
        assert all(0 <= off <= 64 - size for off, size in reqs)
        cycles[seed] = [sorted(s for _, s in reqs[i:i + 32])
                        for i in range(0, 96, 32)]
        assert reqs == list(itertools.islice(arrivals.requests(mix, seed),
                                             96))
    assert cycles[1] == cycles[2 ** 31 + 11] == [list(range(1, 33))] * 3


def event(name, start, end, device):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_trace_reduction():
    events = [event(trace.SLICE, 100, 200, False),
              event("aten::copy_", 100, 130, False),
              event("cudaStreamSynchronize", 170, 200, False),
              event("k1", 90, 120, True), event("k2", 110, 140, True),
              event("k2", 150, 160, True), event("Command Buffer Full", 160,
                                                 190, True)]
    out = trace.reduce_events(events)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(50e-6)  # 100-140 and 150-160
    assert out["by_name"][0] == ["k2", pytest.approx(40e-6)]
    gaps = out["gaps"]
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(40e-6)]
    assert gaps[1] == ["(no host op)", pytest.approx(10e-6)]


def run_cell(root, cell, trace_=0):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert run.main(["--workload", cell, "--seed", "2147483659",
                         "--seconds", "0.3", "--trace", str(trace_)],
                        root=root, device=torch.device("cpu")) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture
def fp32_root(tmp_path):
    root = micro.build(tmp_path, FP32_LIMITS)
    path = root / "benchmark" / "configs" / "micro.json"
    config = json.loads(path.read_text())
    config["serve"]["compute_dtype"] = config["train"]["compute_dtype"] \
        = "float32"
    path.write_text(json.dumps(config))
    return root


@pytest.mark.parametrize("cell", ["micro.bulk", "micro.small",
                                  "micro.train"])
def test_a_sound_run_is_correct(fp32_root, cell):
    result = run_cell(fp32_root, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def half_chunk(real):
    """Half of each chunk computed; the other half's rows repeat it."""
    def forward(self, model, dev, device):
        half = dev.shape[0] // 2
        out = real(self, model, dev[:half], device)
        return {k: torch.cat([v, v[:dev.shape[0] - half]]) for k, v in
                out.items()}
    return forward


def altered_answer(real):
    """Each chunk's first answer replaced by its second's."""
    def forward(self, model, dev, device):
        out = real(self, model, dev, device)
        return {k: torch.cat([v[1:2], v[1:]]) for k, v in out.items()}
    return forward


@pytest.mark.parametrize("fault", [half_chunk, altered_answer])
@pytest.mark.parametrize("cell", ["micro.bulk", "micro.small"])
def test_a_serving_fault_is_not_correct(fp32_root, monkeypatch, cell, fault):
    from protopformer_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(ServingEngine, "_forward_on",
                        fault(ServingEngine._forward_on))
    assert not run_cell(fp32_root, cell)["correct"]


def test_scores_of_another_image_are_not_correct(fp32_root, monkeypatch):
    """The logits right, each image's rollout scores those of the image
    before it in the chunk."""
    from protopformer_tpu_torch.serving import ServingEngine

    real = ServingEngine._forward_on

    def forward(self, model, dev, device):
        out = real(self, model, dev, device)
        out["cls_token_attn"] = torch.roll(out["cls_token_attn"], 1, 0)
        return out

    monkeypatch.setattr(ServingEngine, "_forward_on", forward)
    result = run_cell(fp32_root, "micro.small")
    assert not result["correct"]
    assert result["checks"]["logit_err"]["value"] <= FP32_LIMITS["logit_err"]
    assert result["checks"]["attn_err"]["value"] > FP32_LIMITS["attn_err"]


def unchanged_state(monkeypatch):
    from protopformer_tpu_torch.train.state import TrainState

    def apply_gradients(self, ema_decay=None):
        self.step += 1
        return self

    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def wrap_step(monkeypatch, change):
    from protopformer_tpu_torch import train

    real = train.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda state, batch, gen, gate: change(step, state, batch,
                                                      gen, gate)

    monkeypatch.setattr(train, "make_train_step", make)


def half_batch(monkeypatch):
    def change(step, state, batch, gen, gate):
        half = batch["image"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, gen, gate)
    wrap_step(monkeypatch, change)


def doubled_leaf(monkeypatch):
    """One leaf's update is written twice where the step produces it."""
    def change(step, state, batch, gen, gate):
        leaf = next(state.model.parameters())
        before = leaf.detach().clone()
        state, metrics = step(state, batch, gen, gate)
        with torch.no_grad():
            leaf.add_(leaf - before)
        return state, metrics
    wrap_step(monkeypatch, change)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   doubled_leaf])
def test_a_training_fault_is_not_correct(fp32_root, monkeypatch, fault):
    fault(monkeypatch)
    assert not run_cell(fp32_root, "micro.train")["correct"]


def test_readers_find_nothing_where_nothing_ran():
    from benchmark import harness as h

    record = {"config": micro.MICRO, "window": {"images": 0, "window_s": 1.0,
                                                "chunk": 8,
                                                "step_spans_s": []},
              "slice": {"busy_s": 0.0, "window_s": 1.0, "ops": [],
                        "chunks": 0, "launches": {}}}
    for path in sorted((h.BENCH / "metrics").glob("*.py")):
        assert h.load_module(path).read(record) is None, path.name


def test_k1_roofline_raises_where_k1_ran_under_other_names():
    from benchmark import harness as h

    reader = h.load_module(h.BENCH / "metrics" / "k1_roofline.serve_bulk.py")
    config = h.read_json(h.BENCH / "configs" / "deit_tiny224_cub.json")
    record = {"config": config, "window": {"chunk": 160},
              "slice": {"launches": {"fused_attention_block_stats": 11},
                        "ops": [["attention_stats_v2_kernel", 0, 2000]]}}
    with pytest.raises(RuntimeError, match="matches"):
        reader.read(record)
    record["slice"]["ops"] = [["block_stats_kernel", 0, 2000]] * 11
    assert 0 < reader.read(record) < 100
    # K2 launched on its own: its kernel's name is K1's select's
    record["slice"]["launches"]["fused_map_stats"] = 1
    assert reader.read(record) is None
