"""The port's tracing (``utils/profiling.py``): spans recorded only while a
profiler collects, on the profiler's clock, with their parents, request
ids and device times; the always-on counters behind ``launch_counts``; and
the serving engine's and the kernels' spans and counters.

The file imports neither JAX nor the JAX package. Its ``gpu`` tests need
the card and run there as ``tests/test_torch_gpu.py`` does:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py -q
"""

import statistics
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from protopformer_tpu_torch import kernels
from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
from protopformer_tpu_torch.kernels import _build
from protopformer_tpu_torch.kernels import attention_core as ac
from protopformer_tpu_torch.kernels import stats
from protopformer_tpu_torch.models import construct_ppnet
from protopformer_tpu_torch.serving import ServingEngine
from protopformer_tpu_torch.utils import profiling

torch.set_num_threads(1)

BATCH = 8
IMG = 32


@pytest.fixture
def fresh(monkeypatch):
    """An empty span buffer and counter registry for the test."""
    monkeypatch.setattr(profiling, "_SESSIONS", profiling._Sessions())
    monkeypatch.setattr(profiling, "_COUNTS", {})


@pytest.fixture(scope="module")
def engine():
    """A bf16 speed engine on the CPU at ``deit_micro_test``'s widths: the
    kernel structure (K1 on the pre-prune blocks, K3 after) on the plain
    versions."""
    backbone = backbone_preset("deit_micro_test", img_size=IMG, patch_size=8,
                               rollout_discard_ratio=0.7)
    ppnet = PPNetConfig(prototype_shape=(8, 16, 1, 1), num_classes=4,
                        reserve_layers=(2,), reserve_token_nums=(9,),
                        global_proto_per_class=2)
    model = construct_ppnet(backbone, ppnet,
                            generator=torch.Generator().manual_seed(0))
    return ServingEngine(backbone, ppnet, model.state_dict(),
                         batch_size=BATCH, compute_dtype=torch.bfloat16,
                         device="cpu")


def images(n):
    return np.random.default_rng(n).integers(0, 256, (n, IMG, IMG, 3),
                                             dtype=np.uint8)


def collecting():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def raise_if_called(*args, **kwargs):
    raise AssertionError("called while no profiler collects")


def test_spans_record_nothing_and_enter_no_record_function_while_off(
        fresh, monkeypatch, engine):
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        raise_if_called)
    monkeypatch.setattr(torch.profiler, "record_function", raise_if_called)
    monkeypatch.setattr(torch.cuda, "Event", raise_if_called)
    res = engine(images(20))
    assert res.logits.shape == (20, 4)
    with profiling.span("a", request=3):
        with profiling.span("b", torch.ones(2, 3)):
            assert profiling.launch_events(None) is None
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_a_span_while_off_allocates_nothing():
    x = torch.ones(2, 3)

    def run(n):
        for _ in range(n):
            with profiling.span("serve.stage"):
                pass
            with profiling.span("fused_attention_block_stats", x):
                pass

    run(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        run(10_000)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024  # 20,000 spans


def test_an_engine_request_records_its_spans_and_counters(fresh, engine):
    with collecting():
        engine(images(20))  # chunks of 8: 8 + 8 + 4 and 4 pad rows
    spans = profiling.spans()
    names = by_name(spans)
    assert [len(names[n]) for n in (
        "serve.request", "serve.stage", "serve.stage.wait",
        "serve.stage.copy", "serve.dispatch", "serve.fetch")] \
        == [1, 3, 3, 3, 3, 1]
    (request,) = names["serve.request"]
    rid = request["request"]
    assert rid is not None and request["parent"] is None
    ids = {s["id"]: s for s in spans}
    for name in ("serve.stage", "serve.dispatch", "serve.fetch"):
        assert all(s["parent"] == request["id"] for s in names[name])
    for name in ("serve.stage.wait", "serve.stage.copy"):
        assert all(ids[s["parent"]]["name"] == "serve.stage"
                   for s in names[name])
    k1 = names["fused_attention_block_stats"]
    assert len(k1) == 3 * 2  # the pre-prune blocks of each chunk
    assert all(ids[s["parent"]]["name"] == "serve.dispatch" for s in k1)
    assert all(s["attrs"] == {"batch": BATCH, "tokens": 17, "route": "plain"}
               and s["device_ms"] is None and s["timed_launches"] == 0
               for s in k1)
    assert all(s["device_ms"] is None for s in spans)
    assert {s["request"] for s in spans} == {rid}
    assert all(s["start_ns"] <= s["end_ns"] for s in spans)
    assert request["start_ns"] <= min(s["start_ns"] for s in spans)
    assert request["end_ns"] >= max(s["end_ns"] for s in spans)
    # the first chunk is dispatched after the three are staged
    first = min(s["start_ns"] for s in names["serve.dispatch"])
    assert max(s["end_ns"] for s in names["serve.stage"]) <= first
    assert profiling.counts("serve.") == {
        "serve.requests": 1, "serve.chunks": 3, "serve.rows_asked": 20,
        "serve.rows_computed": 24,
        "serve.bytes_staged": 3 * BATCH * IMG * IMG * 3}


def test_requests_take_new_ids_and_children_inherit_them(fresh, engine):
    with collecting():
        engine(images(3))
        engine(images(3))
        with profiling.span("outer", request=7):
            with profiling.span("inner"):
                pass
    names = by_name(profiling.spans())
    first, second = (s["request"] for s in names["serve.request"])
    assert first != second
    assert {s["request"] for s in names["serve.dispatch"]} == {first, second}
    assert names["inner"][0]["request"] == 7
    assert names["inner"][0]["parent"] == names["outer"][0]["id"]


def test_one_k1_span_a_k1_call(fresh):
    qkv = torch.randn(2, 17, 3 * 32).to(torch.bfloat16)
    with collecting():
        for _ in range(3):
            ac.fused_attention_block_stats(qkv, 2, 0.9, False)
        stats.fused_map_stats(torch.rand(2, 17, 17), 0.9, True)
    names = by_name(profiling.spans())
    assert len(names["fused_attention_block_stats"]) == 3
    assert len(names["fused_map_stats"]) == 1
    assert names["fused_map_stats"][0]["attrs"] == {
        "batch": 2, "tokens": 17, "route": "plain"}


class _Library:
    """Stands in for the kernel library: every launcher returns 0 and every
    size query 0."""

    def __getattr__(self, name):
        return lambda *args: 0


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_launch_counts_agree_with_the_wrappers_calls(fresh, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: _Library())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "on_device", lambda dev: _NullStream())
    calls = {
        "fused_attention_block_stats": (3, lambda: ac.block_stats_cuda(
            _meta((2, 16, 96), torch.bfloat16), 2, 10, False)),
        "fused_map_stats": (2, lambda: stats.map_stats_cuda(
            _meta((2, 16, 16)), 10, True)),
        "fused_attention_mean_padded": (4, lambda: ac.mean_padded_cuda(
            _meta((2, 16, 96)), _meta((2, 16)), 2, 12)),
        "fused_attention_core": (1, lambda: ac.core_cuda(
            _meta((2, 16, 96)), None, 2)),
        "fused_attention_core_padded": (5, lambda: ac.core_padded_cuda(
            _meta((2, 16, 96)), _meta((2, 16)), 2, 12)),
    }
    assert set(calls) == set(kernels.WRAPPERS)
    for n, call in calls.values():
        for _ in range(n):
            call()
    want = {name: n for name, (n, _) in calls.items()}
    assert kernels.launch_counts() == want
    assert profiling.counts("launches.") == {
        f"launches.{name}": n for name, n in want.items()}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


class _NullStream:
    def __enter__(self):
        return 0

    def __exit__(self, *exc):
        return False


def test_a_span_starts_on_the_profilers_clock(fresh):
    with collecting() as prof:
        for i in range(50):
            with profiling.span(f"clock.{i}"):
                time.sleep(1e-4)
    base = prof.profiler.kineto_results.trace_start_ns()
    twins = {e.name: e for e in prof.events()
             if e.name.startswith("clock.")}
    gaps = [abs(s["start_ns"] - (base + twins[s["name"]].time_range.start
                                 * 1000))
            for s in profiling.spans()]
    assert len(gaps) == 50
    assert statistics.median(gaps) < 1e6


def test_the_buffer_keeps_its_bound_and_counts_what_it_drops(fresh,
                                                               monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with collecting():
        for i in range(8):
            with profiling.span(f"s{i}"):
                pass
    assert [s["name"] for s in profiling.spans()] == [f"s{i}" for i in
                                                      range(5)]
    assert profiling.dropped() == 3
    with collecting():
        with profiling.span("next"):
            pass
    (only,) = profiling.spans()
    assert only["name"] == "next" and profiling.dropped() == 0


def test_each_profiler_start_opens_a_session(fresh):
    with collecting():
        with profiling.span("first"):
            pass
    (first,) = profiling.spans()
    with profiling.span("off"):
        pass
    with collecting():
        with profiling.span("second"):
            pass
    (second,) = profiling.spans()
    assert second["name"] == "second"
    assert second["session"] == first["session"] + 1


def test_spans_refuse_to_answer_without_the_profilers_start_call(
        fresh, monkeypatch):
    monkeypatch.setattr(profiling, "_HOOKED", False)
    with collecting():
        with profiling.span("s"):
            pass
    with pytest.raises(RuntimeError, match="_run_on_profiler_start"):
        profiling.spans()


class _Event:
    """Stands in for ``torch.cuda.Event``: records where it was recorded,
    and a pair's elapsed time is 1.5 ms."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.stream = None

    def record(self, stream):
        self.stream = stream

    def synchronize(self):
        assert self.stream is not None

    def elapsed_time(self, end):
        assert self.stream is end.stream is not None
        return 1.5


def test_a_kernel_entrys_span_times_only_the_launches_inside_it(
        fresh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    operand = SimpleNamespace(shape=(160, 197, 576), is_cuda=True)

    def launch(stream="s"):
        pair = profiling.launch_events(stream)
        if pair is not None:
            pair[1].record(stream)
        return pair

    with collecting():
        assert launch() is None  # no span open
        with profiling.span("serve.dispatch"):
            assert launch() is None  # not a kernel entry's span
            with profiling.span("fused_attention_block_stats", operand):
                assert launch() is not None
                assert launch() is not None
                with profiling.span("inner"):
                    assert launch() is None  # the innermost span's
                capturing[0] = True
                assert launch() is None  # a graph being captured
                capturing[0] = False
            with profiling.span("fused_attention_mean_padded", operand):
                pass
    names = by_name(profiling.spans())
    (k1,) = names["fused_attention_block_stats"]
    assert k1["timed_launches"] == 2 and k1["device_ms"] == 3.0
    assert k1["attrs"] == {"batch": 160, "tokens": 197, "route": "cuda"}
    (k3,) = names["fused_attention_mean_padded"]
    assert k3["timed_launches"] == 0 and k3["device_ms"] is None
    assert names["serve.dispatch"][0]["device_ms"] is None
    assert profiling.spans() == profiling.spans()  # resolved once


def test_a_region_span_times_its_whole_body_with_one_pair(fresh,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "s")
    region = SimpleNamespace(shape=(160, 576, 576), is_cuda=True,
                             device="cuda:0")
    with collecting():
        with profiling.span("r", region=region, attrs={"heads": 8}):
            # a kernel launched inside is not added to the region's pair
            assert profiling.launch_events("s") is None
        with profiling.span("cpu", region=torch.ones(2), attrs={"a": 1}):
            pass
        capturing[0] = True
        with profiling.span("captured", region=region):
            pass
    names = by_name(profiling.spans())
    (r,) = names["r"]
    assert r["device_ms"] == 1.5 and r["timed_launches"] == 0
    assert r["attrs"] == {"heads": 8}
    (cpu,) = names["cpu"]
    assert cpu["device_ms"] is None and cpu["attrs"] == {"a": 1}
    assert names["captured"][0]["device_ms"] is None
    assert profiling.span("after", region=region) is profiling._OFF


def test_trace_serving_names_idle_gaps_by_program_span():
    from protopformer_tpu_torch.cli import trace_serving as ts

    def ev(cat, name, ts_, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts_, "dur": dur}

    events = [ev("user_annotation", ts.SLICE, 0, 100),
              ev("user_annotation", "serve.request", 0, 100),
              ev("kernel", "k", 10, 20), ev("kernel", "k", 40, 20),
              ev("gpu_memcpy", "Memcpy HtoD", 90, 5),
              ev("gpu_user_annotation", "serve.dispatch", 0, 100),
              ev("user_annotation", "serve.stage.copy", 30, 10),
              ev("cpu_op", "aten::copy_", 31, 8),
              ev("user_annotation", "serve.dispatch", 60, 30),
              ev("user_annotation", "not a span", 61, 2)]
    names = {"serve.request", "serve.stage.copy", "serve.dispatch"}
    gaps = ts.name_gaps(events, names)
    assert [(g["ms"], g["span"], g["host_op"]) for g in gaps] == [
        (0.03, "serve.dispatch", "(none)"),
        (0.01, "serve.request", "(none)"),
        (0.01, "serve.stage.copy", "aten::copy_"),
        (0.005, "serve.request", "(none)")]
    assert ts.idle_by_span(gaps) == pytest.approx(
        {"serve.dispatch": 0.03, "serve.request": 0.015,
         "serve.stage.copy": 0.01})
    assert sum(e - s for s, e in ts.busy(events, ts.window(events))) == 45


def test_trace_serving_reports_a_request_on_the_cpu(fresh, engine,
                                                     tmp_path, monkeypatch):
    from protopformer_tpu_torch.cli import trace_serving as ts

    monkeypatch.setattr(ts, "WARM_REQUESTS", 1)
    rep = ts.report(engine, images(20), tmp_path)
    assert (tmp_path / "trace.json").exists()
    assert rep["chunks"] == 3
    # a request, its fetch, and a chunk's stage (with its two children),
    # dispatch and the kernel entries: K1 on 2 blocks, K3 on one
    assert rep["spans_per_chunk"] == pytest.approx((2 + 3 * 7) / 3)
    assert rep["timed_launches_per_chunk"] == 0
    assert len(rep["lead_in_ms"]) == 1 and rep["lead_in_ms"][0] > 0
    assert rep["busy_ms"] == 0 and rep["device_idle"] == 1
    assert len(rep["gaps"]) == 1 and rep["gaps"][0]["ms"] == pytest.approx(
        rep["slice_ms"]) == pytest.approx(rep["idle_ms"])
    assert set(rep["span_us"]) == {"off", "on"}
    assert len(rep["slice_ms_spans_on"]) == len(rep["slice_ms_spans_off"]) \
        == ts.PAIRS
    # the last profile held the spans off: its session recorded none
    assert profiling.spans() == []
    assert profiling._autograd_profiler is torch.autograd.profiler


def test_counters_count_and_reset(fresh):
    profiling.count("a.x")
    profiling.count("a.x", 4)
    profiling.count("b.y", 2)
    assert profiling.counts() == {"a.x": 5, "b.y": 2}
    profiling.reset_counts("a.")
    assert profiling.counts() == {"a.x": 0, "b.y": 2}


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_device_timed_span_times_its_kernel_on_the_card(fresh, cuda):
    qkv = torch.randn(160, 197, 3 * 192, device=cuda).to(torch.bfloat16)
    ac.fused_attention_block_stats(qkv, 3, 0.9, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(5):
            ac.fused_attention_block_stats(qkv, 3, 0.9, False)
        torch.cuda.synchronize()
    spans = profiling.spans()
    assert len(spans) == 5
    assert all(s["attrs"] == {"batch": 160, "tokens": 197, "route": "cuda"}
               and s["timed_launches"] == 1 for s in spans)
    # K1 at this shape takes ~0.17 ms on an H100
    assert all(0.02 < s["device_ms"] < 50 for s in spans)


@pytest.mark.gpu
def test_a_kernel_span_leaves_the_hosts_preparation_out(fresh, cuda):
    """On a device with nothing queued, the span's device time is its
    kernel's, not the host's work before the launch."""
    qkv = torch.randn(160, 197, 3 * 192, device=cuda).to(torch.bfloat16)
    ac.fused_attention_block_stats(qkv, 3, 0.9, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(9):
            torch.cuda.synchronize()
            ac.fused_attention_block_stats(qkv, 3, 0.9, False)
        torch.cuda.synchronize()
    kernel_ms = statistics.median(
        e.time_range.elapsed_us() / 1e3 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "block_stats_kernel" in e.name)
    got = [s["device_ms"] for s in profiling.spans()]
    # the median: the profiler's first launches wait on its own buffers
    assert kernel_ms * 0.9 < statistics.median(got) < kernel_ms * 1.2 + 0.03, \
        (kernel_ms, got)


@pytest.mark.gpu
def test_a_region_span_times_its_work_on_the_card(fresh, cuda):
    a = torch.randn(4096, 4096, device=cuda, dtype=torch.bfloat16)
    torch.mm(a, a)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(5):
            torch.cuda.synchronize()
            with profiling.span("region", region=a):
                for _ in range(4):
                    torch.mm(a, a)
        torch.cuda.synchronize()
        start.record()
        for _ in range(4):
            torch.mm(a, a)
        end.record()
        torch.cuda.synchronize()
    got = [s["device_ms"] for s in profiling.spans()]
    want = start.elapsed_time(end)
    # four 4096^3 bf16 products: ~0.6 ms on an H100
    assert len(got) == 5 and all(0.1 < g < 50 for g in got)
    assert want * 0.8 < statistics.median(got) < want * 1.25 + 0.05, \
        (want, got)


@pytest.mark.gpu
def test_no_event_is_recorded_on_the_card_while_off(fresh, cuda,
                                                     monkeypatch):
    qkv = torch.randn(8, 197, 3 * 192, device=cuda).to(torch.bfloat16)
    monkeypatch.setattr(torch.cuda, "Event", raise_if_called)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        raise_if_called)
    ac.fused_attention_block_stats(qkv, 3, 0.9, False)
    torch.cuda.synchronize()
    assert profiling.spans() == []
