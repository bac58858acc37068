"""The CaiT serving cell's benchmark files against the port, on the CPU at
a micro CaiT (64 px in patches of 16: 16 patches; 48 wide, 4 heads, 3
self-attention and 2 class-attention blocks; the reserve at class-attention
block 1 keeping 9; discard 0.7, which keeps the top-9 set free of tied
zero scores):

  * the plain reference (``benchmark/reference/cait.py``), the CaiT weights,
    counts, compared numbers, driver, controls and readers import neither
    JAX nor the program;
  * the port's fp32 ``ServingEngine`` computes the reference's function in
    exact and in speed mode (maps stored in bf16): logits within 1e-3 of
    the logits' spread, rollout scores within 1e-5 of the largest;
  * the seeded weights load strictly into the port's CaiT PPNet;
  * ``counts/cait.py`` against a count by hand, and ``keep_miss`` against
    a count of the kept patches; ``attn_err`` recorded by the controls and
    not compared;
  * the port's CaiT spans, recorded under a CPU profiler with their
    attributes and parents, and not without one; its always-on counter;
  * each new reader's value, and the serving cells' device readers', on a
    synthetic record, and None without spans.

The file imports neither JAX nor the JAX package.
"""

import ast
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import compare, compare_cait, harness, weights_cait
from benchmark.counts import BF16_FLOPS, HBM_BYTES_PER_S
from benchmark.counts import cait as counts
from benchmark.reference import cait as reference
from protopformer_tpu_torch.serving import ServingEngine
from protopformer_tpu_torch.utils import profiling

torch.set_num_threads(1)

CELL = "cait_s24_384_cub.cait_serve_bulk"
NEW_FILES = [
    "reference/cait.py", "weights_cait.py", "counts/cait.py",
    "compare_cait.py", "drivers/serve_cait.py", "controls_cait.py",
    "metrics/mfu.cait_serve_bulk.py",
    "metrics/th_attn_roofline.cait_serve_bulk.py",
    "metrics/signed_stats_roofline.cait_serve_bulk.py",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "protopformer_tpu",
             "protopformer_tpu_torch")
IMG, BATCH = 64, 8


def micro_config(exact=True, dtype="float32"):
    """The cell's configuration file at the micro sizes."""
    c = harness.read_json(harness.BENCH / "configs" / "cait_s24_384_cub.json")
    c["backbone"].update(img_size=IMG, patch_size=16, embed_dim=48, depth=3,
                         num_heads=4, rollout_discard_ratio=0.7)
    c["head"].update(num_prototypes=40, proto_dim=16, num_classes=4,
                     global_proto_per_class=3, reserve_token_nums=[9])
    c["serve"].update(compute_dtype=dtype, batch_size=BATCH)
    c["serve"]["rollout"]["rollout_exact_discard"] = exact
    return c


def engine_for(c, sd):
    backbone, ppnet, dtype = harness.port_configs(c, "serve")
    return ServingEngine(backbone, ppnet, sd, batch_size=BATCH,
                         compute_dtype=dtype, with_attn=True, device="cpu")


@pytest.mark.parametrize("path", NEW_FILES)
def test_the_new_files_import_neither_jax_nor_the_program(path):
    tree = ast.parse((harness.BENCH / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if n.split(".")[0] in FORBIDDEN], \
            (path, names)


@pytest.mark.parametrize("exact", [True, False])
def test_fp32_serving_matches_the_reference(exact):
    c = micro_config(exact=exact)
    cfg = harness.model_cfg(c, "serve")
    sd = weights_cait.state_dict(cfg, 2 ** 31 + 7, "cpu")
    imgs = weights_cait.uint8_images(12, IMG, 7, "cpu")
    res = engine_for(c, sd)(imgs)
    ref = reference.serve_logits(sd, cfg, torch.from_numpy(imgs), 5)
    nums = compare.serve_numbers(res.logits, ref["logits"],
                                 res.cls_token_attn, ref["cls_token_attn"])
    nums.update(compare.serve_readings(res.logits, ref["logits"]))
    assert nums["logit_err"] < 1e-3 and nums["attn_err"] < 1e-5, nums
    assert nums["top1_gap"] == 0.0


def test_the_reference_sees_a_fault_in_the_attention():
    """A talking-heads mix off by a tenth in one block moves the reference
    far past the sound limits: the seeded gammas keep the attention in the
    residual stream."""
    c = micro_config()
    cfg = harness.model_cfg(c, "serve")
    sd = weights_cait.state_dict(cfg, 3, "cpu")
    imgs = torch.from_numpy(weights_cait.uint8_images(8, IMG, 3, "cpu"))
    ref = reference.serve_logits(sd, cfg, imgs, 8)
    bad = dict(sd)
    key = "features.blocks.1.attn.proj_w.weight"
    bad[key] = sd[key] * 1.1
    off = reference.serve_logits(bad, cfg, imgs, 8)
    nums = compare.serve_numbers(off["logits"].numpy(), ref["logits"],
                                 off["cls_token_attn"].numpy(),
                                 ref["cls_token_attn"])
    assert nums["logit_err"] > 1e-2 and nums["attn_err"] > 1e-3, nums


def test_the_weights_load_strictly_and_follow_the_seed():
    from protopformer_tpu_torch.models import construct_ppnet

    c = micro_config()
    cfg = harness.model_cfg(c, "serve")
    backbone, ppnet, _ = harness.port_configs(c, "serve")
    a, b = (weights_cait.state_dict(cfg, 2 ** 33 + 1, "cpu") for _ in range(2))
    model = construct_ppnet(backbone, ppnet)
    model.load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [k for k, _, _ in weights_cait.layout(cfg)] == list(a)
    gammas = [v for k, v in a.items() if k.endswith(("gamma_1", "gamma_2"))]
    assert len(gammas) == 2 * (3 + 2)
    assert all(0.0 <= float(g.min()) and float(g.max()) <= 1.0
               and float(g.std()) > 0.1 for g in gammas)
    assert all(not a[k].any() for k in a
               if k.endswith(("proj_l.bias", "proj_w.bias")))
    c = weights_cait.state_dict(cfg, 2 ** 33 + 2, "cpu")
    assert not torch.equal(a["features.pos_embed"], c["features.pos_embed"])


def test_counts_match_a_count_by_hand():
    cfg = harness.model_cfg(micro_config(), "serve")
    P, C, H, hidden = 16, 48, 4, 192
    patch = 2 * P * (3 * 16 * 16) * C
    sa = (2 * P * C * 3 * C + 2 * P * P * C * 2 + 2 * H * H * P * P * 2
          + 2 * P * C * C + 2 * P * C * hidden * 2)
    ca = (2 * C * C + 2 * (P + 1) * C * C * 2 + 2 * (P + 1) * C * 2
          + 2 * C * C + 2 * C * hidden * 2)
    rollout = 3 * 2 * P * P
    head = (2 * 10 * C * 16 + 2 * 9 * 16 * 40 + 2 * 16 * 12
            + 2 * (40 + 12) * 4)
    assert counts.forward_flops(cfg) == patch + 3 * sa + 2 * ca + rollout \
        + head
    b, n = 160, 576
    th_bytes = b * n * 1152 * 2 + b * n * 384 * 2 + b * n * n * 2
    assert counts.talking_heads_bound_s(b, n, 8, 48, "bfloat16") == max(
        th_bytes / HBM_BYTES_PER_S,
        (4 * b * n * n * 384 + 4 * b * 64 * n * n) / BF16_FLOPS)
    assert counts.signed_stats_bound_s(b, n, "float32") == \
        (b * n * n * 4 + b * 4 + b * n * 4) / HBM_BYTES_PER_S


@pytest.fixture
def fresh(monkeypatch):
    """An empty span buffer and counter registry for the test."""
    monkeypatch.setattr(profiling, "_SESSIONS", profiling._Sessions())
    monkeypatch.setattr(profiling, "_COUNTS", {})


def test_the_cait_spans_and_counters_record_only_under_a_profiler(fresh):
    c = micro_config(exact=False, dtype="bfloat16")
    cfg = harness.model_cfg(c, "serve")
    engine = engine_for(c, weights_cait.state_dict(cfg, 5, "cpu"))
    imgs = weights_cait.uint8_images(12, IMG, 5, "cpu")  # 2 chunks
    engine(imgs)
    assert profiling.spans() == []
    assert profiling.counts("cait.") == {"cait.maps_searched": 6}
    with profile(activities=[ProfilerActivity.CPU]):
        engine(imgs)
    spans = profiling.spans()
    ids = {s["id"]: s for s in spans}
    names = {}
    for s in spans:
        names.setdefault(s["name"], []).append(s)
    assert {n: len(v) for n, v in names.items() if n.startswith("cait.")} \
        == {"cait.talking_heads": 6, "cait.signed_stats": 6,
            "cait.rollout": 2, "cait.class_attn": 4}
    for s in names["cait.talking_heads"]:
        assert s["attrs"] == {"batch": BATCH, "tokens": 16, "heads": 4,
                              "head_dim": 12, "map_dtype": "bfloat16"}
    for s in names["cait.signed_stats"]:
        assert s["attrs"] == {"batch": BATCH, "tokens": 16,
                              "map_dtype": "bfloat16", "passes": 16}
    for name in ("cait.talking_heads", "cait.signed_stats", "cait.rollout",
                 "cait.class_attn"):
        for s in names[name]:
            assert ids[s["parent"]]["name"] == "serve.dispatch"
            assert s["device_ms"] is None  # no card: nothing timed
    assert profiling.counts("cait.") == {"cait.maps_searched": 12}
    engine(imgs)
    assert profiling.counts("cait.") == {"cait.maps_searched": 18}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read


def _record(chunks=2):
    return {"config": harness.read_json(
                harness.BENCH / "configs" / "cait_s24_384_cub.json"),
            "window": {"images": 3200, "window_s": 10.0, "requests": 10,
                       "chunk": 160},
            "slice": {"chunks": chunks, "busy_s": 1.5, "window_s": 1.6,
                      "ops": [], "launches": {}}}


def _span(name, attrs, device_ms):
    return {"name": name, "id": 1, "parent": None, "request": 1,
            "session": 1, "start_ns": 0, "end_ns": 1, "attrs": attrs,
            "timed_launches": 0, "device_ms": device_ms}


def test_the_readers_read_a_synthetic_record(monkeypatch):
    th = {"batch": 160, "tokens": 576, "heads": 8, "head_dim": 48,
          "map_dtype": "bfloat16"}
    st = {"batch": 160, "tokens": 576, "map_dtype": "bfloat16", "passes": 16}
    spans = ([_span("cait.talking_heads", th, 5.0) for _ in range(24)]
             + [_span("cait.signed_stats", st, 2.0) for _ in range(24)]
             + [_span("cait.rollout", {}, 1.0)])
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    rec = _record()
    assert _reader("device_idle.serve_bulk")(rec) == pytest.approx(
        100 * (1 - 1.5 / 1.6))
    assert _reader("chunk_busy_ms.serve_bulk")(rec) == 750.0
    cfg = harness.model_cfg(rec["config"], "serve")
    assert _reader("mfu.cait_serve_bulk")(rec) == pytest.approx(
        100 * counts.forward_flops(cfg) * 320 / BF16_FLOPS)
    assert _reader("th_attn_roofline.cait_serve_bulk")(rec) == pytest.approx(
        100 * counts.talking_heads_bound_s(160, 576, 8, 48, "bfloat16")
        / 5e-3)
    assert _reader("signed_stats_roofline.cait_serve_bulk")(rec) == \
        pytest.approx(100 * counts.signed_stats_bound_s(160, 576, "bfloat16")
                      / 2e-3)
    assert 0 < _reader("th_attn_roofline.cait_serve_bulk")(rec) < 100


@pytest.mark.parametrize("spans", [[], [_span("cait.talking_heads", {}, None),
                                        _span("cait.signed_stats", {}, None)],
                                   [_span("serve.dispatch", {}, None)]])
def test_the_span_readers_find_nothing_without_timed_spans(monkeypatch,
                                                           spans):
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    for name in ("th_attn_roofline.cait_serve_bulk",
                 "signed_stats_roofline.cait_serve_bulk"):
        assert _reader(name)(_record()) is None
        assert _reader(name)(_record(chunks=0)) is None


def test_the_cait_mfu_reads_nothing_of_a_deit_configuration():
    rec = _record()
    rec["config"] = harness.read_json(
        harness.BENCH / "configs" / "deit_b384_cub.json")
    assert _reader("mfu.cait_serve_bulk")(rec) is None


def test_the_cell_is_in_the_benchmark():
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "serve_cait"
    assert cell.traffic["sizes"] == [320, 320]
    assert cell.traffic["pool_images"] == 640 and cell.traffic["with_attn"]
    assert set(cell.limits) == {"logit_err", "keep_miss"}
    assert [m["name"] for m in cell.end_to_end] == ["serve_img_per_s",
                                                    "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        [p.split("/")[1][:-3] for p in NEW_FILES if p.startswith("metrics/")]
        + ["device_idle.serve_bulk", "chunk_busy_ms.serve_bulk"])
    assert json.loads(json.dumps(cell.config))["reduced"] == []


def test_the_cait_driver_replaces_only_weights_and_reference():
    driver = harness.load_module(harness.BENCH / "drivers" / "serve_cait.py")
    serve = harness.load_module(harness.BENCH / "drivers" / "serve.py")
    assert issubclass(driver.Driver, driver._serve.Driver)
    assert driver._serve.weights is weights_cait
    assert driver._serve.reference is reference
    assert serve.weights.__name__ == "benchmark.weights"
    assert serve.reference.__name__ == "benchmark.reference.ppnet"
    assert np.array_equal(
        weights_cait.uint8_images(2, 16, 1, "cpu"),
        serve.weights.uint8_images(2, 16, 1, "cpu"))


def test_keep_miss_counts_the_reference_patches_the_program_drops():
    ref = torch.tensor([[5.0, 4.0, 3.0, 2.0, 1.0, 0.0],
                        [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]])
    same = ref.numpy()
    assert compare_cait.keep_miss(same, ref, 3) == 0.0
    one = np.array([[5.0, 4.0, 0.5, 2.0, 1.0, 0.0], same[1]])
    assert compare_cait.keep_miss(one, ref, 3) == pytest.approx(1 / 3)
    assert compare_cait.keep_miss(-same, ref, 3) == 1.0
    numbers = compare_cait.for_config({"reserve_token_nums": [3]})
    logits = torch.randn(2, 4)
    out = numbers.serve_numbers(logits.numpy(), logits, one, ref)
    assert set(out) == {"logit_err", "keep_miss"}
    assert out["keep_miss"] == pytest.approx(1 / 3)
    assert set(numbers.serve_numbers(logits.numpy(), logits)) == {"logit_err"}


def test_the_driver_checks_keep_miss_against_the_reference():
    """The cell's driver at the micro configuration: its window's requests
    checked against the reference in fp32, every number near nought, and
    ``attn_err`` not among them."""
    from types import SimpleNamespace

    c = micro_config()
    traffic = {"driver": "serve_cait", "sizes": [6, 10], "pool_images": 16,
               "with_attn": True, "check_images": 12, "trace_requests": 1}
    cell = SimpleNamespace(config=c, traffic=traffic, name="micro")
    module = harness.load_module(harness.BENCH / "drivers" / "serve_cait.py")
    driver = module.Driver(harness.Context(cell, 2 ** 40 + 3, 0.2,
                                           torch.device("cpu")))
    driver.setup()
    window = driver.window()
    driver.release()
    nums = driver.check()
    assert window["failed"] == 0 and window["attempted"] >= 1
    assert set(nums) == {"logit_err", "keep_miss"}
    assert nums["logit_err"] < 1e-3 and nums["keep_miss"] == 0.0


def test_the_controls_record_attn_err_beside_the_compared_numbers():
    """``attn_err`` is a reading: the controls' numbers carry it, the
    cell's limits do not name it."""
    ref = torch.tensor([[5.0, 4.0, 3.0, 2.0, 1.0, 0.0]])
    got = np.array([[5.0, 4.0, 0.5, 2.0, 1.0, 0.0]])
    logits = torch.randn(1, 4)
    recorded = compare_cait.for_config({"reserve_token_nums": [3]},
                                       record_attn_err=True)
    out = recorded.serve_numbers(logits.numpy(), logits, got, ref)
    assert set(out) == {"logit_err", "attn_err", "keep_miss"}
    assert out["attn_err"] == pytest.approx(2.5 / 5.0)
    assert "attn_err" not in harness.find_cell(
        harness.read_json(harness.ROOT / "BENCHMARK.json"), CELL).limits
    controls = harness.load_module(harness.BENCH / "controls_cait.py")
    assert controls._controls.reference is reference


@pytest.mark.parametrize("fusion", ["mean", "max", "min"])
@pytest.mark.parametrize("exact", [True, False])
def test_the_self_attention_block_stores_its_map_fused(fusion, exact):
    """A talking-heads block fuses its heads and stores the map in the
    rollout's dtype: fp32 in exact mode, bf16 in speed mode."""
    from protopformer_tpu_torch.models.layers import TalkingHeadAttention

    map_dtype = torch.float32 if exact else torch.bfloat16
    torch.manual_seed(0)
    attn = TalkingHeadAttention(48, 4, True, torch.float32,
                                head_fusion=fusion, map_dtype=map_dtype)
    x = torch.randn(2, 16, 48)
    with torch.inference_mode():
        _, fmap = attn(x)
        H, d = 4, 12
        q, k, _ = attn.qkv(x).reshape(2, 16, 3, H, d).permute(2, 0, 3, 1, 4)
        logits = (q * d ** -0.5) @ k.transpose(-1, -2)
        logits = attn.proj_l(logits.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        probs = torch.softmax(logits, dim=-1)
        probs = attn.proj_w(probs.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        want = {"mean": probs.mean(1), "max": probs.amax(1),
                "min": probs.amin(1)}[fusion]
    assert fmap.shape == (2, 16, 16) and fmap.dtype == map_dtype
    tol = 1e-6 if exact else 1e-2
    torch.testing.assert_close(fmap.float(), want.to(map_dtype).float(),
                               atol=tol, rtol=tol)
