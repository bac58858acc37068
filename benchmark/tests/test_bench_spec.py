"""BENCHMARK.json names only files that exist, in names and units of the
allowed characters, and every per-layer metric is read in cells that
report the end-to-end metric it moves."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(LINE.match(w) for w in SPEC["command"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.find_cell(SPEC, cell)
    bench = harness.BENCH
    assert (bench / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert (bench / "limits" / f"{cell}.json").exists()
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert (bench / "metrics" / f"{m['name']}.py").exists()
    assert "setup_s" in [m["name"] for m in c.end_to_end]
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.chips == 1


def test_names_units_and_lines():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert harness.read_json(harness.ROOT / c["file"])["source"] \
            == c["source"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_a_per_layer_metric_is_read_where_its_metric_is(metric):
    m = {x["name"]: x for x in SPEC["per_layer"]}[metric]
    e2e = {x["name"]: x for x in SPEC["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert cell in CELLS
        assert harness.reports(e2e[m["moves"]], cell, [])
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
