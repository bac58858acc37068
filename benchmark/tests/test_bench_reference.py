"""The plain reference against the program at micro sizes on the CPU:
in float32 the two compute the same function, so the served logits and
rollout scores and a train step's loss, gradients and update agree to
float32 rounding; the reference imports nothing of the program."""

import ast
import json

import pytest
import torch

from benchmark import compare, harness, weights
from benchmark.reference import ppnet as reference
from benchmark.tests import micro


def micro_config(dtype="float32", exact=True):
    c = json.loads(json.dumps(micro.MICRO))
    c["serve"]["compute_dtype"] = dtype
    c["serve"]["rollout"]["rollout_exact_discard"] = exact
    return c


@pytest.mark.parametrize("exact", [True, False])
def test_fp32_serving_matches_the_reference(exact):
    from protopformer_tpu_torch.serving import ServingEngine

    c = micro_config(exact=exact)
    cfg = harness.model_cfg(c, "serve")
    sd = weights.state_dict(cfg, 7, "cpu")
    backbone, ppnet, dtype = harness.port_configs(c, "serve")
    engine = ServingEngine(backbone, ppnet, sd, batch_size=8,
                           compute_dtype=dtype, with_attn=True, device="cpu")
    imgs = weights.uint8_images(12, 64, 7, "cpu")
    res = engine(imgs)
    ref = reference.serve_logits(sd, cfg, torch.from_numpy(imgs), 5)
    nums = compare.serve_numbers(res.logits, ref["logits"],
                                 res.cls_token_attn, ref["cls_token_attn"])
    nums.update(compare.serve_readings(res.logits, ref["logits"]))
    assert nums["logit_err"] < 1e-3 and nums["attn_err"] < 1e-5
    assert nums["top1_gap"] == 0.0


def test_fp32_train_steps_match_the_reference(tmp_path):
    root = micro.build(tmp_path)
    spec = harness.read_json(root / "BENCHMARK.json")
    cell = harness.find_cell(spec, "micro.train", root)
    cell.config["train"]["compute_dtype"] = "float32"
    ctx = harness.Context(cell, 11, 0.0, torch.device("cpu"))
    driver = cell.driver().Driver(ctx)
    driver.setup()
    driver.release()
    nums = driver.check()
    assert driver.readings["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3
    assert nums["change_gap"] < 1e-3


def test_the_weights_follow_the_seed():
    cfg = harness.model_cfg(micro.MICRO, "serve")
    a, b = (weights.state_dict(cfg, 2 ** 31 + 5, "cpu") for _ in range(2))
    c = weights.state_dict(cfg, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["features.pos_embed"], c["features.pos_embed"])
    assert (weights.uint8_images(3, 64, 9, "cpu")
            == weights.uint8_images(3, 64, 9, "cpu")).all()


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "contextlib",
                                              "typing", "__future__",
                                              "benchmark"), (path, name)
                if name.startswith("benchmark"):
                    assert name.startswith("benchmark.reference"), name
