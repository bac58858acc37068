"""The port's CLIs driven as a user runs them, on the CPU (``--device
cpu``): ``cli.train`` (epochs, checkpoints, every ``--resume`` form,
``--eval``), ``cli.export``, ``cli.visualize`` and
``cli.eval_interpretability``, each against the JAX package's CLI or
functions on the same weights where both exist.

Tolerances: exact, but the evaluation of a JAX-exported ``.pth``, whose
loss is held within 1e-4 of the JAX eval step's (the fp32 parity
contract) with the same top-1 accuracy.

``torch.utils.tensorboard`` pulls in TensorFlow where it is installed (tens
of seconds to import); these runs write the JSONL metrics only, and one
test holds the TensorBoard branch with a stand-in writer.
"""

import json
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import main_train as j_main_train
from protopformer_tpu.checkpoint import (
    export_ppnet_state_dict as j_export,
    save_torch_checkpoint as j_save_pth,
)
from protopformer_tpu_torch.checkpoint import (
    CheckpointManager,
    export_ppnet_state_dict,
)
from protopformer_tpu_torch.cli import eval_interpretability as t_interp
from protopformer_tpu_torch.cli import export as t_export
from protopformer_tpu_torch.cli import train as t_train_cli
from protopformer_tpu_torch.cli import visualize as t_visualize
from tests.test_cli_tools import PP_ARGS
from tests.test_cli_tools import _make_cub_tree
from tests.torch_port import jax_params

# the JAX CLI tests' 200-class micro head; the prune keeps all 16 tokens
# (the CLIs' discard 0.9 ties the micro model's top-9, ROADMAP F2)
CUB_ARGS = [*PP_ARGS, "--reserve_token_nums", "16"]
MICRO = [
    "--base_architecture=deit_micro_test", "--data_set=synthetic",
    "--data_path=", "--img_size=32", "--input_size=32", "--batch_size=8",
    "--warmup-epochs=1", "--prototype_shape", "8", "16", "1", "1",
    "--reserve_layers", "2", "--reserve_token_nums", "9",
    "--use_global=True", "--use_ppc_loss=True", "--global_proto_per_class=2",
    "--num_workers=2", "--compute_dtype=float32", "--save_ep_freq=1",
]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _train(*flags, device="cpu"):
    argv = [*MICRO, *flags] + ([f"--device={device}"] if device else [])
    return t_train_cli.main(t_train_cli.get_args_parser().parse_args(argv))


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """Two epochs of the micro PPNet (drop path 0.1, the CLI default)."""
    out = str(tmp_path_factory.mktemp("run") / "a")
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        stats = _train("--epochs=2", f"--output_dir={out}")
    finally:
        mp.undo()
    return out, stats


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_two_epochs_write_checkpoints_and_metrics(run_a):
    out, stats = run_a
    assert sorted(os.listdir(f"{out}/checkpoints")) == [
        "checkpoint-0.pth", "checkpoint-1.pth"]
    assert [e["epoch"] for e in stats["epochs"]] == [0, 1]
    assert all(e["img_per_sec"] > 0 and e["save_seconds"] > 0
               for e in stats["epochs"])
    epochs = [m for m in _metrics(out) if "epoch/val_acc1" in m]
    assert [m["step"] for m in epochs] == [0, 1]
    assert any("train/loss" in m for m in _metrics(out))
    payload = _payload(f"{out}/checkpoints/checkpoint-1.pth")
    assert payload["epoch"] == 1 and payload["step"] == 16
    assert payload["args"]["drop_path"] == 0.1


@pytest.mark.parametrize("form", ["epoch file", "root", "latest"])
def test_eval_resume_reproduces_the_logged_epoch(run_a, tmp_path, form):
    out, _ = run_a
    resume = {"epoch file": f"{out}/checkpoints/checkpoint-1.pth",
              "root": f"{out}/checkpoints", "latest": "latest"}[form]
    output_dir = out if form == "latest" else str(tmp_path)
    stats = _train("--epochs=2", "--eval", f"--resume={resume}",
                   f"--output_dir={output_dir}")
    logged = [m for m in _metrics(out) if "epoch/val_acc1" in m][-1]
    assert stats["acc1"] == logged["epoch/val_acc1"]
    assert stats["loss"] == logged["epoch/val_loss"]


def test_resume_continues_bit_equal_to_the_continuous_run(run_a, tmp_path):
    """Trap (b) through the CLI: epoch 1 resumed from epoch 0's file into
    another directory saves what the continuous run saved."""
    out, _ = run_a
    _train("--epochs=2", f"--resume={out}/checkpoints/checkpoint-0.pth",
           f"--output_dir={tmp_path}")
    want = _payload(f"{out}/checkpoints/checkpoint-1.pth")
    got = _payload(f"{tmp_path}/checkpoints/checkpoint-1.pth")
    assert os.listdir(f"{tmp_path}/checkpoints") == ["checkpoint-1.pth"]
    for key in ("model", "model_ema"):
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (key, k)
    for i, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    assert torch.equal(got["generator"], want["generator"])
    assert got["step"] == want["step"] == 16


def test_a_bogus_resume_raises_before_the_model_is_built(tmp_path,
                                                         monkeypatch):
    import protopformer_tpu_torch.models as models

    def never(*args, **kwargs):
        raise AssertionError("the model was built")

    monkeypatch.setattr(models, "construct_ppnet", never)
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        _train("--epochs=1", "--resume=/nonexistent/ckpt",
               f"--output_dir={tmp_path}")


@pytest.mark.parametrize("use_global", [True, False])
def test_pth_resume_loads_the_model_only(tmp_path, monkeypatch, use_global):
    """A reference-layout .pth with ``epoch`` 0: the weights load, training
    starts at epoch 1; without a global branch its global prototypes are
    not loaded (the file's class-identity head has 10 a class)."""
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet

    model = construct_ppnet(
        backbone_preset("deit_micro_test"),
        PPNetConfig(prototype_shape=(8, 16, 1, 1), num_classes=4,
                    reserve_layers=(2,), reserve_token_nums=(9,),
                    global_proto_per_class=2),
        generator=torch.Generator().manual_seed(9))
    sd = export_ppnet_state_dict(model, global_proto_per_class=10)
    if use_global:
        sd["last_layer_global.weight"] = model.last_layer_global.weight
    torch.save({"model": sd, "epoch": 0}, tmp_path / "ref.pth")
    monkeypatch.setenv("PPF_CACHE_DIR", str(tmp_path / "cache"))
    stats = _train("--epochs=1", "--eval", f"--resume={tmp_path}/ref.pth",
                   f"--use_global={use_global}", f"--output_dir={tmp_path}")
    assert 0.0 <= stats["acc1"] <= 100.0
    stats = _train("--epochs=2", f"--resume=file://{tmp_path}/ref.pth",
                   f"--use_global={use_global}",
                   f"--output_dir={tmp_path}/run")
    assert [e["epoch"] for e in stats["epochs"]] == [1]


def _export(*flags):
    return t_export.main(t_export.get_parser().parse_args(
        [*MICRO, "--device=cpu", *flags]))


@pytest.mark.parametrize("use_ema", [False, True])
def test_export_writes_the_checkpoints_weights(run_a, tmp_path, use_ema):
    out, _ = run_a
    path = str(tmp_path / "export.pth")
    _export(f"--resume={out}/checkpoints/checkpoint-0.pth",
            f"--export_path={path}", *(["--use_ema"] if use_ema else []))
    got = _payload(path)["model"]
    want = _payload(f"{out}/checkpoints/checkpoint-0.pth")[
        "model_ema" if use_ema else "model"]
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the default checkpoint directory: the latest epoch
    _export(f"--output_dir={out}", f"--export_path={path}")
    latest = _payload(f"{out}/checkpoints/checkpoint-1.pth")["model"]
    assert torch.equal(_payload(path)["model"]["prototype_vectors"],
                       latest["prototype_vectors"])


def test_jax_export_evaluates_as_jax_does(tmp_path):
    """A JAX PPNet exported by the JAX package (no JAX training run),
    evaluated by ``cli.train --eval``: loss within 1e-4 of the JAX eval
    step's over the same batches, the same top-1 accuracy. The CLI's
    discard 0.9 leaves 8-14 of the micro model's 16 rollout scores at
    exactly 0, and torch and JAX break top-k ties differently (ROADMAP
    F2), so the prune keeps all 16 tokens here."""
    from protopformer_tpu.data import (
        HostDataLoader,
        build_dataset_index,
        build_eval_transform,
    )
    from protopformer_tpu.models import construct_ppnet
    from protopformer_tpu.train import make_eval_step
    from protopformer_tpu.train.loop import evaluate

    flags = [*MICRO, "--reserve_token_nums", "16"]
    cfg = j_main_train.config_from_args(
        j_main_train.get_args_parser().parse_args(flags))
    params = jax_params(cfg.backbone, cfg.ppnet, seed=4)
    j_save_pth(str(tmp_path / "jax.pth"), j_export(
        params, "deit", cfg.backbone.depth,
        global_proto_per_class=cfg.ppnet.global_proto_per_class))
    loader = HostDataLoader(
        build_dataset_index("synthetic", "", train=False),
        build_eval_transform(32), 12, shuffle=False, num_workers=2)
    model = construct_ppnet(cfg.backbone, cfg.ppnet, jnp.float32)
    want = evaluate(make_eval_step(model, cfg.ppnet.use_global), params,
                    loader)
    got = _train("--epochs=1", "--eval", f"--resume={tmp_path}/jax.pth",
                 "--reserve_token_nums", "16", f"--output_dir={tmp_path}")
    assert got["acc1"] == want["acc1"]
    assert abs(got["loss"] - want["loss"]) <= 1e-4
    assert got["global_acc1"] == want["global_acc1"]


def test_metric_writer_writes_tensorboard_when_it_imports(tmp_path,
                                                          monkeypatch):
    from protopformer_tpu_torch.utils import MetricWriter

    scalars = []

    class Writer:
        def __init__(self, log_dir, flush_secs):
            assert log_dir == os.path.join(str(tmp_path), "tf-logs")

        def add_scalar(self, k, v, step):
            scalars.append((k, v, step))

        def close(self):
            scalars.append("closed")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    writer = MetricWriter(str(tmp_path))
    writer.write(3, {"a": 1.5})
    writer.close()
    assert scalars == [("a", 1.5, 3), "closed"]
    assert _metrics(str(tmp_path))[0]["a"] == 1.5


# --- the tools' CLIs on a CUB tree -----------------------------------------

@pytest.fixture(scope="module")
def cub(tmp_path_factory):
    """A CUB_200_2011 tree of 8 images (4 test) with parts, and one set of
    JAX weights for the 200-class micro head, exported by the JAX package
    (the .pth the port's CLIs load)."""
    from protopformer_tpu.core.config import PPNetConfig, backbone_preset

    root = tmp_path_factory.mktemp("cub")
    _make_cub_tree(root, n_imgs=8)
    bk = backbone_preset("deit_micro_test", drop_path_rate=0.0)
    pp = PPNetConfig(prototype_shape=(400, 16, 1, 1), num_classes=200,
                     reserve_layers=(2,), reserve_token_nums=(16,),
                     use_global=True, global_proto_per_class=1)
    params = jax_params(bk, pp, seed=0)
    j_save_pth(str(root / "export.pth"), j_export(
        params, "deit", bk.depth, global_proto_per_class=1))
    return root, bk, pp, params


def _json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


def _sums(module, monkeypatch):
    """Record the (hit_sum, vis_sum) ``module.aggregate_score`` gets."""
    seen = []
    real = module.aggregate_score

    def capture(hit_sum, vis_sum, part_thresh):
        seen.append((hit_sum.copy(), vis_sum.copy()))
        return real(hit_sum, vis_sum, part_thresh)

    monkeypatch.setattr(module, "aggregate_score", capture)
    return seen


def _jax_consistency_score(root, bk, pp, params):
    """JAX's ``consistency_score`` over the tree as
    ``main_eval_interpretability.py`` feeds it (batches of 3, box 20 px)."""
    from PIL import Image

    from protopformer_tpu.data import HostDataLoader
    from protopformer_tpu.data.datasets import build_cub_index
    from protopformer_tpu.data.local_parts import load_cub_parts
    from protopformer_tpu.data.transforms import build_square_transform
    from protopformer_tpu.models import construct_ppnet
    from protopformer_tpu.tools.eval_interpretability import (
        ConsistencyConfig,
        consistency_score,
    )

    base = str(root / "CUB_200_2011")
    index = build_cub_index(base, train=False)
    sizes = {}
    for img_id, path in zip(index.image_ids, index.paths):
        with Image.open(path) as im:
            sizes[int(img_id)] = im.size
    loader = HostDataLoader(index, build_square_transform(32), 3,
                            shuffle=False, num_workers=2)

    def with_positions():
        pos = 0
        for batch in loader:
            n = batch["label"].shape[0]
            batch["position"] = np.arange(pos, pos + n) % len(index)
            pos += int(batch["valid"].sum())
            yield batch

    return consistency_score(
        construct_ppnet(bk, pp), params, with_positions(),
        load_cub_parts(base), np.asarray(index.image_ids), sizes, pp,
        ConsistencyConfig(half_size=10, img_size=32))


def test_eval_interpretability_cli_scores_as_jax(cub, capsys, monkeypatch):
    """The same part hits and visibility counts for class 0's prototypes
    (the only class of the tree), so the same score."""
    from protopformer_tpu.tools import eval_interpretability as j_eval
    from protopformer_tpu_torch.tools import eval_interpretability as t_eval

    root, *weights = cub
    t_sums, j_sums = _sums(t_eval, monkeypatch), _sums(j_eval, monkeypatch)
    got = t_interp.main([
        *CUB_ARGS, "--data_path", str(root / "CUB_200_2011"),
        "--batch_size", "3", "--half_size", "10",
        "--resume", str(root / "export.pth"), "--device", "cpu"])
    assert _json_line(capsys) == {"consistency_score": got}
    assert got == _jax_consistency_score(root, *weights)
    (t_hit, t_vis), (j_hit, j_vis) = t_sums[0], j_sums[0]
    np.testing.assert_array_equal(t_vis, j_vis)
    np.testing.assert_array_equal(t_hit, j_hit)
    assert j_vis[:2].sum() == 2 * 4 * 8 and 0 < j_hit.sum() < j_vis.sum()


def test_visualize_cli_writes_each_class_image_set(cub, tmp_path):
    root, *_ = cub
    written = t_visualize.main([
        *CUB_ARGS, "--data_set", "CUB2011U", "--data_path", str(root),
        "--vis_classes", "0", "--imgs_per_class", "3", "--batch_size", "2",
        "--visual_type", "slim_gaussian",
        "--resume", str(root / "export.pth"),
        "--output_dir", str(tmp_path), "--device", "cpu"])
    # 3 of the 4 test images (all class 0): an overlay a prototype, a mask
    want = sorted(f"slim_gaussian/class_0/img{i}_{kind}.png" for i in range(3)
                  for kind in ("proto0_overlay", "proto1_overlay",
                               "discard_mask"))
    assert sorted(os.path.relpath(p, tmp_path) for p in written) == want
    assert sorted(str(p.relative_to(tmp_path))
                  for p in tmp_path.rglob("*.png")) == want


# --- the presets ------------------------------------------------------------

PRESETS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "protopformer_tpu_torch", "cli", "presets")


def _preset_flags(name, **values):
    """The flags a preset passes to its CLI, its shell variables set."""
    values = {"model": "deit_tiny_patch16_224", "reserve_layer_idx": "11",
              "seed": "1028", "batch_size": "128", "resume": "w.pth",
              **values}
    flags = []
    with open(os.path.join(PRESETS, f"{name}.sh")) as f:
        for line in f:
            line = line.strip().rstrip("\\").strip()
            if line.startswith("--"):
                for k, v in values.items():
                    line = line.replace(f"${k}", v)
                line = line.replace("${DATA_PATH:-", "").replace("}", "")
                flags += line.split()
    return flags


@pytest.mark.parametrize("name", ["train_cub", "train_dogs", "train_car",
                                  "visualize", "eval_interpretability"])
def test_presets_parse_and_run_the_ports_clis(name):
    """Each preset calls ``python -m protopformer_tpu_torch.cli.<tool>``
    with flags its parser takes; chip_smoke.py trains with
    train_cub.sh's."""
    import chip_smoke

    with open(os.path.join(PRESETS, f"{name}.sh")) as f:
        text = f.read()
    tool = name if not name.startswith("train") else "train"
    assert f"python -m protopformer_tpu_torch.cli.{tool} " in text
    flags = _preset_flags(name)
    if tool == "train":
        args = t_train_cli.get_args_parser().parse_args(flags)
        assert args.epochs == 200 and args.use_ppc_loss
    else:
        module = t_visualize if tool == "visualize" else t_interp
        args = module.get_args(flags)
        assert args.resume == "w.pth"
    if name == "train_cub":
        assert set(chip_smoke.CUB_PRESET) - {"--num_workers=8"} <= set(flags)
