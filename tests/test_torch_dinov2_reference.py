"""The DINOv2 serving cell's benchmark files and the port's DINOv2 backbone
with registers, on the CPU at a micro DINOv2-reg (56 px in patches of 14:
16 patches; 4 registers; 64 wide, 4 heads, 3 blocks, the gated FFN at
DINOv2's hidden rule (176); the reserve at block 2 keeping 9; discard 0.7,
which keeps the top-9 set free of tied zero scores):

  * the plain reference (``benchmark/reference/dinov2.py``), the DINOv2
    weights, counts, driver, controls and readers import neither JAX nor
    the program;
  * the port's fp32 ``ServingEngine`` computes the reference's function in
    exact and in speed mode (maps stored in bf16), with the gather at the
    prune point and without: logits within 1e-3 of the logits' spread,
    rollout scores within 1e-5 of the largest;
  * the registers are never ranked (the scores are the patches') nor
    gathered as patches, and every policy and gather keeps them;
  * the seeded weights load strictly into the port's DINOv2 PPNet, under
    DINOv2's own module names;
  * ``counts/dinov2.py`` against a count by hand;
  * the ``dinov2.swiglu`` span recorded under a CPU profiler with its
    attributes (the last block's tokens: the prefix and the kept
    patches), and not without one;
  * each new reader's value on a synthetic record, and None without spans;
  * the driver's sample: ``check_images`` images from every chunk of one
    request, each at its offset in the pool;
  * at a prefix of one token (DeiT) ``reserve_policy`` and the gather are
    the one-token forms, bit for bit.

The file imports neither JAX nor the JAX package.
"""

import ast
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import compare, compare_cait, counts, harness, weights_dinov2
from benchmark.counts import BF16_FLOPS, HBM_BYTES_PER_S
from benchmark.counts import dinov2 as dcounts
from benchmark.reference import dinov2 as reference
from protopformer_tpu_torch.serving import ServingEngine
from protopformer_tpu_torch.utils import profiling

torch.set_num_threads(1)

CELL = "dinov2_g14_reg518_cub.dinov2_serve_bulk"
CONFIG = "dinov2_g14_reg518_cub.json"
NEW_FILES = [
    "reference/dinov2.py", "weights_dinov2.py", "counts/dinov2.py",
    "drivers/serve_dinov2.py", "controls_dinov2.py",
    "metrics/mfu.dinov2_serve_bulk.py",
    "metrics/swiglu_roofline.dinov2_serve_bulk.py",
    "metrics/k1_span_roofline.dinov2_serve_bulk.py",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "protopformer_tpu",
             "protopformer_tpu_torch")
IMG, BATCH, PATCHES, PREFIX = 56, 8, 16, 5


def micro_config(exact=True, dtype="float32", gather="auto"):
    """The cell's configuration file at the micro sizes."""
    c = harness.read_json(harness.BENCH / "configs" / CONFIG)
    c["backbone"].update(img_size=IMG, patch_size=14, embed_dim=64, depth=3,
                         num_heads=4, rollout_discard_ratio=0.7,
                         prune_gather=gather)
    c["head"].update(num_prototypes=40, proto_dim=16, num_classes=4,
                     global_proto_per_class=3, reserve_layers=[2],
                     reserve_token_nums=[9])
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


@pytest.mark.parametrize("gather", ["auto", "on"])
@pytest.mark.parametrize("exact", [True, False])
def test_fp32_serving_matches_the_reference(exact, gather):
    c = micro_config(exact=exact, gather=gather)
    cfg = harness.model_cfg(c, "serve")
    sd = weights_dinov2.state_dict(cfg, 2 ** 31 + 7, "cpu")
    imgs = weights_dinov2.uint8_images(12, IMG, 7, "cpu")
    res = engine_for(c, sd)(imgs)
    ref = reference.serve_logits(sd, cfg, torch.from_numpy(imgs), 5)
    assert res.cls_token_attn.shape == (12, PATCHES)
    nums = compare.serve_numbers(res.logits, ref["logits"],
                                 res.cls_token_attn, ref["cls_token_attn"])
    nums.update(compare.serve_readings(res.logits, ref["logits"]))
    assert nums["logit_err"] < 1e-3 and nums["attn_err"] < 1e-5, nums
    assert nums["top1_gap"] == 0.0
    assert compare_cait.keep_miss(res.cls_token_attn, ref["cls_token_attn"],
                                  9) == 0.0


def test_the_reference_sees_a_fault_in_the_registers():
    """Registers off by a tenth move the reference's logits and scores far
    past the sound ones: they take part in every block's attention."""
    c = micro_config()
    cfg = harness.model_cfg(c, "serve")
    sd = weights_dinov2.state_dict(cfg, 3, "cpu")
    imgs = torch.from_numpy(weights_dinov2.uint8_images(8, IMG, 3, "cpu"))
    ref = reference.serve_logits(sd, cfg, imgs, 8)
    bad = dict(sd)
    bad["features.register_tokens"] = sd["features.register_tokens"] * 1.1
    off = reference.serve_logits(bad, cfg, imgs, 8)
    nums = compare.serve_numbers(off["logits"].numpy(), ref["logits"],
                                 off["cls_token_attn"].numpy(),
                                 ref["cls_token_attn"])
    assert nums["logit_err"] > 1e-3 and nums["attn_err"] > 1e-4, nums


def _micro_backbone(dtype=torch.float32):
    from protopformer_tpu_torch.core.config import backbone_preset
    from protopformer_tpu_torch.models import create_backbone
    from protopformer_tpu_torch.models.layers import seeded_init_

    bk = backbone_preset("dinov2_micro_test", rollout_discard_ratio=0.7)
    model = create_backbone(bk, dtype)
    seeded_init_(model, model, bk.arch, 0.5,
                 torch.Generator().manual_seed(4))
    return model.eval()


def test_the_registers_are_never_ranked_and_always_kept(monkeypatch):
    """The rollout scores are the 16 patches'; the policy at the prune
    point keeps the prefix of 5 and 9 patches; the gathered forward keeps
    the prefix rows and the kept patches' rows of the policy forward."""
    import protopformer_tpu_torch.models.deit as deit
    from protopformer_tpu_torch.ops import tokens

    model = _micro_backbone()
    x = torch.rand((3, IMG, IMG, 3), generator=torch.Generator()
                   .manual_seed(5))
    seen = []
    policy = tokens.reserve_policy

    def spy(scores, k, seq_len, prefix=1):
        out = policy(scores, k, seq_len, prefix=prefix)
        seen.append((scores.shape, seq_len, prefix, out))
        return out

    with torch.inference_mode():
        prefix, patches = model.embed_all(x)
        assert prefix.shape[1] == PREFIX and patches.shape[1] == PATCHES
        monkeypatch.setattr(deit, "reserve_policy", spy)
        full, scores = model.masked_forward(prefix, patches, [(2, 9)])
        monkeypatch.undo()
        kept, g_scores = model.masked_forward(prefix, patches, [(2, 9)],
                                              gather_final=True)
    (shape, seq_len, got_prefix, (pol, idx)), = seen
    assert shape == (3, PATCHES) and seq_len == PREFIX + PATCHES
    assert got_prefix == PREFIX
    assert bool((pol[:, :PREFIX] == 1).all())
    assert int(pol.sum(dim=1).min()) == int(pol.sum(dim=1).max()) == 14
    assert int(idx.max()) < PATCHES
    assert torch.equal(scores, g_scores)
    assert kept.shape == (3, PREFIX + 9, 64)
    want = torch.cat([full[:, :PREFIX], torch.gather(
        full[:, PREFIX:], 1, idx[:, :, None].expand(-1, -1, 64))], dim=1)
    torch.testing.assert_close(kept, want, atol=1e-5, rtol=1e-5)


def test_the_prefix_length_is_checked():
    model = _micro_backbone()
    x = torch.rand((2, IMG, IMG, 3))
    with torch.inference_mode():
        prefix, patches = model.embed_all(x)
        with pytest.raises(ValueError, match="5 prefix tokens"):
            model.masked_forward(prefix[:, :1], patches, [(2, 9)])
    assert model.feature_maps(x).shape == (2, PATCHES, 64)


def test_at_one_prefix_token_the_policy_and_gather_are_unchanged():
    """DeiT's prefix of one token: ``reserve_policy`` equals the one-token
    form bit for bit, and the gathered DeiT forward carries its CLS row
    ahead of the kept patches."""
    from protopformer_tpu_torch.core.config import backbone_preset
    from protopformer_tpu_torch.models import create_backbone
    from protopformer_tpu_torch.models.layers import seeded_init_
    from protopformer_tpu_torch.ops.tokens import (
        reserve_policy,
        topk_sorted_indices,
    )

    scores = torch.rand((4, 16), generator=torch.Generator().manual_seed(2))
    idx = topk_sorted_indices(scores, 9)
    want = torch.zeros((4, 17))
    want[:, 0] = 1.0
    want.scatter_(1, idx + 1, 1.0)
    for got in (reserve_policy(scores, 9, 17),
                reserve_policy(scores, 9, 17, prefix=1)):
        assert torch.equal(got[0], want) and torch.equal(got[1], idx)

    bk = backbone_preset("deit_micro_test")
    model = create_backbone(bk)
    seeded_init_(model, model, "deit", 1e-5, torch.Generator().manual_seed(3))
    model.eval()
    assert model.num_prefix_tokens == 1
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        cls, patches = model.embed_all(x)
        full, scores = model.masked_forward(cls, patches, [(2, 9)])
        kept, _ = model.masked_forward(cls, patches, [(2, 9)],
                                       gather_final=True)
    assert scores.shape == (2, 16) and kept.shape == (2, 10, 24)
    torch.testing.assert_close(kept[:, 0], full[:, 0], atol=1e-5, rtol=1e-5)


def test_the_weights_load_strictly_and_follow_the_seed():
    from protopformer_tpu_torch.models import construct_ppnet

    c = micro_config()
    cfg = harness.model_cfg(c, "serve")
    backbone, ppnet, _ = harness.port_configs(c, "serve")
    a, b = (weights_dinov2.state_dict(cfg, 2 ** 33 + 1, "cpu")
            for _ in range(2))
    model = construct_ppnet(backbone, ppnet)
    model.load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [k for k, _, _ in weights_dinov2.layout(cfg)] == list(a)
    f = "features."
    assert a[f + "register_tokens"].shape == (1, 4, 64)
    assert a[f + "pos_embed"].shape == (1, 1 + PATCHES, 64)
    assert a[f + "blocks.0.mlp.w12.weight"].shape == (2 * 176, 64)
    assert a[f + "blocks.0.mlp.w3.weight"].shape == (64, 176)
    assert not a[f + "mask_token"].any()
    assert 0.01 < float(a[f + "register_tokens"].std()) < 0.04
    gammas = [v for k, v in a.items() if k.endswith(("ls1.gamma",
                                                     "ls2.gamma"))]
    assert len(gammas) == 2 * 3
    assert all(0.0 <= float(g.min()) and float(g.max()) <= 1.0
               and float(g.std()) > 0.1 for g in gammas)
    c2 = weights_dinov2.state_dict(cfg, 2 ** 33 + 2, "cpu")
    assert not torch.equal(a[f + "register_tokens"],
                           c2[f + "register_tokens"])


def test_a_dinov2_backbone_state_dict_loads_under_its_own_names():
    """The backbone's keys are DINOv2's (``register_tokens``,
    ``mask_token``, ``blocks.{i}.ls1.gamma``, ``mlp.w12``, ``mlp.w3``),
    and the full preset states the published widths."""
    from protopformer_tpu_torch.core.config import (
        BACKBONE_PRESETS,
        PORT_PRESETS,
        backbone_preset,
    )

    model = _micro_backbone()
    keys = set(model.state_dict())
    for k in ("cls_token", "pos_embed", "register_tokens", "mask_token",
              "patch_embed.proj.weight", "blocks.2.ls1.gamma",
              "blocks.2.ls2.gamma", "blocks.2.mlp.w12.bias",
              "blocks.2.mlp.w3.weight", "blocks.2.attn.qkv.bias",
              "norm.weight"):
        assert k in keys, k
    assert not [k for k in keys if "fc1" in k or "gamma_1" in k]
    g = backbone_preset("dinov2_vitg14_reg")
    assert "dinov2_vitg14_reg" in PORT_PRESETS
    assert "dinov2_vitg14_reg" not in BACKBONE_PRESETS
    assert (g.arch, g.embed_dim, g.depth, g.num_heads, g.patch_size,
            g.img_size, g.num_register_tokens, g.num_patches,
            g.num_prefix_tokens) == ("dinov2", 1536, 40, 24, 14, 518, 4,
                                     1369, 5)
    from protopformer_tpu_torch.models.layers import swiglu_hidden
    assert swiglu_hidden(1536, 4.0) == 4096


def test_counts_match_a_count_by_hand():
    cfg = harness.model_cfg(micro_config(), "serve")
    C, h, M, K = 64, 176, PREFIX + PATCHES, PREFIX + 9
    patch = 2 * PATCHES * (3 * 14 * 14) * C

    def blk(n):
        return (2 * n * C * 3 * C + 2 * n * n * C * 2 + 2 * n * C * C
                + 2 * n * C * 2 * h + 2 * n * h * C)

    rollout = 2 * 2 * M * M
    head = (2 * 10 * C * 16 + 2 * 9 * 16 * 40 + 2 * 16 * 12
            + 2 * (40 + 12) * 4)
    assert dcounts.forward_flops(cfg) == patch + 2 * blk(M) + blk(K) \
        + rollout + head
    full = harness.model_cfg(harness.read_json(
        harness.BENCH / "configs" / CONFIG), "serve")
    assert dcounts.block_flops(1374, 1536, 4096) == pytest.approx(89.40e9,
                                                                  rel=1e-3)
    assert dcounts.forward_flops(full) == pytest.approx(3.494e12, rel=1e-3)
    b, n, c = 160, 1374, 1536
    by = (b * n * c * 2 + b * n * 8192 * 2 + b * n * 4096 * 2 + b * n * c * 2
          + (c * 8192 + 8192 + 4096 * c + c) * 2)
    assert dcounts.swiglu_bound_s(b, n, c, 4096) == max(
        by / HBM_BYTES_PER_S, 6 * b * n * c * 4096 / BF16_FLOPS)


@pytest.fixture
def fresh(monkeypatch):
    """An empty span buffer and counter registry for the test."""
    monkeypatch.setattr(profiling, "_SESSIONS", profiling._Sessions())
    monkeypatch.setattr(profiling, "_COUNTS", {})


def test_the_swiglu_span_is_recorded_only_under_a_profiler(fresh):
    c = micro_config(exact=False, dtype="bfloat16")
    cfg = harness.model_cfg(c, "serve")
    engine = engine_for(c, weights_dinov2.state_dict(cfg, 5, "cpu"))
    imgs = weights_dinov2.uint8_images(12, IMG, 5, "cpu")  # 2 chunks
    engine(imgs)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        engine(imgs)
    spans = profiling.spans()
    ids = {s["id"]: s for s in spans}
    ffn = [s for s in spans if s["name"] == "dinov2.swiglu"]
    assert len(ffn) == 6  # 3 blocks, 2 chunks
    assert sorted(s["attrs"]["tokens"] for s in ffn) == [14] * 2 + [21] * 4
    for s in ffn:
        assert {k: v for k, v in s["attrs"].items() if k != "tokens"} == {
            "batch": BATCH, "dim": 64, "hidden": 176}
        assert ids[s["parent"]]["name"] == "serve.dispatch"
        assert s["device_ms"] is None  # no card: nothing timed


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read


def _record(chunks=2, config=CONFIG):
    return {"config": harness.read_json(harness.BENCH / "configs" / config),
            "window": {"images": 1600, "window_s": 20.0, "requests": 5,
                       "chunk": 160},
            "slice": {"chunks": chunks, "busy_s": 3.0, "window_s": 3.1,
                      "ops": [], "launches": {}}}


def _span(name, attrs, device_ms):
    return {"name": name, "id": 1, "parent": None, "request": 1,
            "session": 1, "start_ns": 0, "end_ns": 1, "attrs": attrs,
            "timed_launches": 0, "device_ms": device_ms}


def test_the_readers_read_a_synthetic_record(monkeypatch):
    ffn = {"batch": 160, "tokens": 1374, "dim": 1536, "hidden": 4096}
    k1 = {"batch": 160, "tokens": 1374, "route": "cuda"}
    spans = ([_span("dinov2.swiglu", ffn, 14.0) for _ in range(39)]
             + [_span("fused_attention_block_stats", k1, 20.0)
                for _ in range(39)])
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    rec = _record()
    cfg = harness.model_cfg(rec["config"], "serve")
    assert _reader("mfu.dinov2_serve_bulk")(rec) == pytest.approx(
        100 * dcounts.forward_flops(cfg) * 80 / BF16_FLOPS)
    assert _reader("swiglu_roofline.dinov2_serve_bulk")(rec) == \
        pytest.approx(100 * dcounts.swiglu_bound_s(160, 1374, 1536, 4096)
                      / 14e-3)
    k1_roof = _reader("k1_span_roofline.dinov2_serve_bulk")(rec)
    assert k1_roof == _reader("k1_span_roofline.serve_bulk")(rec)
    assert k1_roof == pytest.approx(
        100 * counts.k1_bound_s(160, 1374, 1536, False) / 20e-3)
    for name in ("swiglu_roofline.dinov2_serve_bulk",
                 "k1_span_roofline.dinov2_serve_bulk"):
        assert 0 < _reader(name)(rec) < 100
    assert _reader("chunk_busy_ms.serve_bulk")(rec) == 1500.0
    # the name-matched reader over the same 39 launches of 20 ms each
    rec["slice"]["launches"] = {"fused_attention_block_stats": 39}
    rec["slice"]["ops"] = [("block_stats_long_kernel<3, false>", 0.0,
                            39 * 20e3)]
    assert _reader("k1_roofline.serve_bulk")(rec) == pytest.approx(
        k1_roof, rel=1e-2)


@pytest.mark.parametrize("spans", [[], [_span("dinov2.swiglu", {}, None),
                                        _span("fused_attention_block_stats",
                                              {}, None)],
                                   [_span("serve.dispatch", {}, None)]])
def test_the_span_readers_find_nothing_without_timed_spans(monkeypatch,
                                                           spans):
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    for name in ("swiglu_roofline.dinov2_serve_bulk",
                 "k1_span_roofline.dinov2_serve_bulk"):
        assert _reader(name)(_record()) is None
        assert _reader(name)(_record(chunks=0)) is None


def test_the_dinov2_mfu_reads_nothing_of_another_configuration():
    for config in ("deit_b384_cub.json", "cait_s24_384_cub.json"):
        assert _reader("mfu.dinov2_serve_bulk")(_record(config=config)) \
            is None


def test_the_cell_is_in_the_benchmark():
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "serve_dinov2"
    assert cell.traffic["sizes"] == [320, 320]
    assert cell.traffic["pool_images"] == 640 and cell.traffic["with_attn"]
    assert cell.traffic["check_images"] == 160
    assert set(cell.limits) == {"logit_err", "keep_miss"}
    assert [m["name"] for m in cell.end_to_end] == ["serve_img_per_s",
                                                    "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        [p.split("/")[1][:-3] for p in NEW_FILES if p.startswith("metrics/")]
        + ["device_idle.serve_bulk", "chunk_busy_ms.serve_bulk",
           "k1_roofline.serve_bulk"])
    config = json.loads(json.dumps(cell.config))
    assert config["reduced"] == []
    b = config["backbone"]
    assert (b["embed_dim"], b["depth"], b["num_heads"], b["patch_size"],
            b["img_size"], b["num_register_tokens"]) == (
        1536, 40, 24, 14, 518, 4)
    assert config["head"]["reserve_layers"] == [39]


def test_the_driver_checks_every_chunk_against_the_reference():
    """The cell's driver at the micro configuration: its window's requests
    served, the sample's ``check_images`` images taken in equal shares
    from both chunks of a longest request and checked against the
    reference in fp32, every number near nought."""
    from types import SimpleNamespace

    c = micro_config()
    traffic = {"driver": "serve_dinov2", "sizes": [6, 16], "pool_images": 24,
               "with_attn": True, "check_images": 8, "trace_requests": 1}
    cell = SimpleNamespace(config=c, traffic=traffic, name="micro")
    module = harness.load_module(harness.BENCH / "drivers" / "serve_dinov2.py")
    assert module._serve.weights is weights_dinov2
    assert module._serve.reference is reference
    driver = module.Driver(harness.Context(cell, 2 ** 40 + 3, 0.2,
                                           torch.device("cpu")))
    driver.setup()
    window = driver.window()
    driver.release()
    picked = driver.sample()
    assert [size for _, size, _ in picked] == [4, 4]
    assert picked[1][0] - picked[0][0] == BATCH
    assert all(len(res.logits) == size and len(res.cls_token_attn) == size
               for _, size, res in picked)
    nums = driver.check()
    assert window["failed"] == 0 and window["attempted"] >= 1
    assert set(nums) == {"logit_err", "keep_miss"}
    assert nums["logit_err"] < 1e-3 and nums["keep_miss"] == 0.0


@pytest.mark.parametrize("size,check,want", [
    (320, 160, [(0, 80), (160, 80)]),
    (330, 160, [(0, 53), (160, 53), (320, 10)]),
    (100, 160, [(0, 100)]),
])
def test_the_sample_takes_a_share_of_every_chunk_at_its_offset(size, check,
                                                               want):
    """``check_images`` // chunks rows from the head of each chunk of the
    longest request (a short last chunk gives what it has), each share's
    rows of the answer and its offset in the pool."""
    from types import SimpleNamespace

    from protopformer_tpu_torch.serving import ServingResult

    module = harness.load_module(harness.BENCH / "drivers" / "serve_dinov2.py")
    cell = SimpleNamespace(config=micro_config(), name="micro", traffic={
        "driver": "serve_dinov2", "sizes": [1, size], "pool_images": 1000,
        "with_attn": True, "check_images": check, "trace_requests": 1})
    driver = module.Driver(harness.Context(cell, 9, 0.2, torch.device("cpu")))
    driver.batch = 160
    rows = np.arange(size, dtype=np.float32)
    res = ServingResult(logits=rows[:, None] * np.ones((1, 4), np.float32),
                        top_class=rows.astype(np.int32),
                        cls_token_attn=rows[:, None] + np.zeros((1, 16)))
    short = ServingResult(np.zeros((1, 4), np.float32),
                          np.zeros(1, np.int32), np.zeros((1, 16)))
    driver.served = [(7, 1, short), (40, size, res)]
    picked = driver.sample()
    assert [(off - 40, n) for off, n, _ in picked] == want
    for off, n, got in picked:
        lo = off - 40
        assert got.top_class.tolist() == list(range(lo, lo + n))
        assert got.logits[:, 0].tolist() == list(range(lo, lo + n))
        assert got.cls_token_attn[:, 3].tolist() == list(range(lo, lo + n))


def test_the_controls_take_the_dinov2_reference():
    controls = harness.load_module(harness.BENCH / "controls_dinov2.py")
    assert controls._controls.reference is reference
    assert controls._controls.serve_controls is controls.serve_controls
    serve = harness.load_module(harness.BENCH / "drivers" / "serve.py")
    assert serve.reference.__name__ == "benchmark.reference.ppnet"
    assert np.array_equal(weights_dinov2.uint8_images(2, 14, 1, "cpu"),
                          serve.weights.uint8_images(2, 14, 1, "cpu"))
