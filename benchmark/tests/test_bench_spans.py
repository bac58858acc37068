"""The readers of the program's spans (``benchmark/spans.py`` and the
``program_span`` metrics) on synthetic span buffers, and on a program
that records none."""

import pytest

from benchmark import counts, harness
from protopformer_tpu_torch.utils import profiling

MS = 1_000_000  # ns


def span(name, sid, request, start_ms, end_ms, device_ms=None, **attrs):
    return {"name": name, "id": sid, "parent": None, "request": request,
            "session": 1, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "attrs": attrs,
            "device_ms": device_ms}


def two_requests():
    """Two requests of two chunks: request 1 dispatches its first chunk at
    12 ms (lead-in 12), request 2 at 107 (lead-in 7)."""
    out = []
    for rid, t0, lead in ((1, 0.0, 12.0), (2, 100.0, 7.0)):
        sid = rid * 100
        out += [span("serve.stage", sid + 1, rid, t0, t0 + 4.0),
                span("serve.stage", sid + 2, rid, t0 + 4.0, t0 + 6.0),
                span("serve.dispatch", sid + 3, rid, t0 + lead,
                     t0 + lead + 3.0),
                span("fused_attention_block_stats", sid + 4, rid,
                     t0 + lead + 1.0, t0 + lead + 1.1, device_ms=0.2,
                     batch=160, tokens=197, route="cuda"),
                span("serve.dispatch", sid + 5, rid, t0 + lead + 20.0,
                     t0 + lead + 21.0),
                span("fused_attention_block_stats", sid + 6, rid,
                     t0 + lead + 20.1, t0 + lead + 20.2, device_ms=0.1,
                     batch=160, tokens=197, route="cuda"),
                span("serve.fetch", sid + 7, rid, t0 + 60.0, t0 + 61.0),
                span("serve.request", sid, rid, t0, t0 + 61.0)]
    return out


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def record(chunks=4):
    config = harness.read_json(harness.BENCH / "configs"
                               / "deit_tiny224_cub.json")
    return {"config": config, "window": {"chunk": 160},
            "slice": {"chunks": chunks, "launches": {}, "ops": []}}


@pytest.fixture
def buffer(monkeypatch):
    spans = two_requests()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    return spans


def test_the_serving_readers(buffer):
    assert reader("lead_in_ms.serve_bulk").read(record()) \
        == pytest.approx(9.5)
    assert reader("stage_ms.serve_bulk").read(record()) == pytest.approx(3.0)
    assert reader("dispatch_ms.serve_bulk").read(record()) \
        == pytest.approx(2.0)


def test_k1_span_roofline_reads_the_spans_not_kernel_names(buffer):
    bound = counts.k1_bound_s(160, 197, 192, False)
    assert reader("k1_span_roofline.serve_bulk").read(record()) \
        == pytest.approx(100.0 * 4 * bound / 0.6e-3)


def test_spans_without_device_time_give_no_device_metric(buffer):
    for s in buffer:
        s["device_ms"] = None
    assert reader("k1_span_roofline.serve_bulk").read(record()) is None
    assert reader("stage_ms.serve_bulk").read(record()) is not None


NEW = ("lead_in_ms.serve_bulk", "stage_ms.serve_bulk",
       "dispatch_ms.serve_bulk", "k1_span_roofline.serve_bulk")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name).read(record()) is None
    monkeypatch.setattr(profiling, "spans", two_requests)
    assert reader(name).read(record(chunks=0)) is None
    # a program without the accessor: the reader does not raise
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(record()) is None


def test_every_new_metric_is_declared_for_both_bulk_cells():
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "serve_img_per_s"
        assert m["workloads"] == ["deit_tiny224_cub.serve_bulk",
                                  "deit_b384_cub.serve_bulk"]
