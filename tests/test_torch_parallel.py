"""The port's several-device layer against the JAX package's: the index
shards (``parallel/multihost.py``), the mesh (``parallel/mesh.py``), the
mesh ``ServingEngine``, and a two-process data-parallel train step and
evaluation over gloo on the CPU.

Tolerances:
  * ``shard_index_for_process`` equal to JAX's (paths, labels, images);
  * the mesh engine (one CPU device listed 8 times, 2 images a device)
    against the JAX engine on its 8-virtual-device mesh: fp32 logits
    within 1e-5, the same ``top_class``, ``cls_token_attn`` within 1e-6;
  * the two-process step (fp32, drop rates 0: each rank's generator is
    seeded ``seed + rank``, so dropout could not match a one-process step
    bit for bit): the loss equal on both ranks; against the port's
    one-process step on the global batch the loss within 1e-5 and the
    parameters after AdamW within 1e-6; against the JAX step on the global
    batch the loss and ``ce_loss`` within rtol 1e-5, as
    ``tests/test_multihost.py`` holds its own runs;
  * the two-process evaluation of 11 samples: the one-process counts
    exactly, the loss sum within 1e-5.
The worker processes import no JAX and are killed when their hard limit
runs out.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.core.config import (
    BackboneConfig,
    OptimConfig as JOptimConfig,
    PPNetConfig,
)
from protopformer_tpu.data.datasets import (
    build_synthetic_index as j_synthetic_index,
)
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.parallel import (
    shard_index_for_process as j_shard_index,
)
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.core.config import OptimConfig
from protopformer_tpu_torch.data import mixup as t_mixup
from protopformer_tpu_torch.data.datasets import build_synthetic_index
from protopformer_tpu_torch.kernels import _build as t_build
from protopformer_tpu_torch.kernels import attention_core as t_attn
from protopformer_tpu_torch.kernels import stats as t_stats
from protopformer_tpu_torch.parallel import (
    assemble_global_batch,
    initialize_multihost,
    is_main_process,
    make_mesh,
    replicate,
    shard_batch,
    shard_index_for_process,
)
from protopformer_tpu_torch.serving import ServingEngine
from protopformer_tpu_torch.utils import profiling
from tests import torch_ddp_common as common
from tests.test_torch_cli import MICRO as CLI_MICRO
from tests.torch_port import jax_params, port_configs, to_np

ROOT = common.ROOT
CPU = torch.device("cpu")


# --- index shards --------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("even", [True, False])
def test_shard_index_matches_jax(count, even):
    j_index = j_synthetic_index(num_samples=10, num_classes=3, image_size=8)
    index = build_synthetic_index(num_samples=10, num_classes=3,
                                  image_size=8)
    for p in range(count):
        want = j_shard_index(j_index, p, count, even=even)
        got = shard_index_for_process(index, p, count, even=even)
        assert got.paths == want.paths
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.images, want.images)
        assert got.num_classes == want.num_classes


def test_shard_index_marks_the_wrapped_duplicates_invalid():
    """10 samples over 4 processes, even: 3 each, samples 0 and 1 wrapped
    onto processes 2 and 3 with ``valid`` 0, so each sample counts once."""
    index = build_synthetic_index(num_samples=10, num_classes=3, image_size=8)
    counted = {}
    for p in range(4):
        shard = shard_index_for_process(index, p, 4)
        assert len(shard) == 3
        for path, v in zip(shard.paths, shard.valid):
            counted[path] = counted.get(path, 0) + v
    assert counted == {path: 1.0 for path in index.paths}
    assert shard_index_for_process(index, 3, 4).valid.tolist() == [1, 1, 0]
    assert shard_index_for_process(index, 0, 1) is index


def test_one_process_defaults_and_the_local_batch():
    assert not initialize_multihost(num_processes=1)
    assert is_main_process()
    index = build_synthetic_index(num_samples=5, image_size=8)
    assert shard_index_for_process(index) is index
    batch = assemble_global_batch(
        {"image": np.ones((2, 8, 8, 3), np.float32),
         "label": np.array([1, 2], np.int32)}, CPU)
    assert batch["image"].shape == (2, 8, 8, 3)
    assert batch["label"].tolist() == [1, 2]


# --- the mesh ------------------------------------------------------------------------

def test_shard_batch_splits_contiguous_rows_and_replicate_copies():
    mesh = make_mesh([CPU] * 4)
    assert mesh.size == 4 and mesh.axis_name == "data"
    x = np.arange(8 * 3).reshape(8, 3)
    parts = shard_batch({"x": x, "y": np.arange(8)}, mesh)
    assert len(parts) == 4
    for d, part in enumerate(parts):
        np.testing.assert_array_equal(part["x"].numpy(), x[2 * d:2 * d + 2])
        assert part["y"].tolist() == [2 * d, 2 * d + 1]
    with pytest.raises(ValueError, match="equal slices"):
        shard_batch(np.zeros((6, 2)), mesh)
    lin = torch.nn.Linear(2, 2)
    copies = replicate(lin, make_mesh([CPU] * 2))
    assert len(copies) == 2 and copies[0] is not lin
    assert all(torch.equal(c.weight, lin.weight) for c in copies)


SERVE_BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, rollout_discard_ratio=0.7,
)
SERVE_PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine on its 8-virtual-device mesh and the port's on a mesh
    of one CPU device listed 8 times, 2 images a device (a chunk of 16),
    and the port's one-device engine at 16, over the same weights."""
    from protopformer_tpu.parallel import make_mesh as j_make_mesh
    from protopformer_tpu.serving import ServingEngine as JServingEngine

    params = jax_params(SERVE_BK, SERVE_PP, seed=1)
    bk, pp = port_configs(SERVE_BK, SERVE_PP)
    sd = state_dict_from_jax(params, "deit", SERVE_BK.depth,
                             SERVE_PP.global_proto_per_class)
    j_mesh = j_make_mesh()
    assert j_mesh.size == 8
    jax_engine = JServingEngine(SERVE_BK, SERVE_PP, params, batch_size=2,
                                compute_dtype=jnp.float32, with_attn=True,
                                mesh=j_mesh, stage_window=2)
    mesh = make_mesh([CPU] * 8)
    port = ServingEngine(bk, pp, sd, batch_size=2,
                         compute_dtype=torch.float32, with_attn=True,
                         stage_window=2, device="cpu", mesh=mesh)
    single = ServingEngine(bk, pp, sd, batch_size=16,
                           compute_dtype=torch.float32, with_attn=True,
                           device="cpu")
    return jax_engine, port, single


@pytest.mark.parametrize("n", [1, 16, 37])
def test_mesh_serving_engine_matches_the_jax_mesh_engine(engines, n):
    jax_engine, port, single = engines
    assert port.batch_size == jax_engine.batch_size == 16
    assert len(port.models) == 8
    imgs = (np.random.default_rng(n).uniform(size=(n, 32, 32, 3))
            * 255).astype(np.uint8)
    want, got, one = jax_engine(imgs), port(imgs), single(imgs)
    assert got.logits.shape == (n, 4)
    np.testing.assert_allclose(got.logits, want.logits, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.top_class, want.top_class)
    np.testing.assert_allclose(got.cls_token_attn, want.cls_token_attn,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.logits, one.logits, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.top_class, one.top_class)
    assert port.last_peak_staged <= port.stage_window


def test_mesh_push_forward_and_probe_match_one_device(engines):
    _, port, single = engines
    imgs = (np.random.default_rng(3).uniform(size=(21, 32, 32, 3))
            * 255).astype(np.uint8)
    got, want = port.push_forward(imgs), single.push_forward(imgs)
    np.testing.assert_allclose(got.proto_acts, want.proto_acts, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.cls_token_attn, want.cls_token_attn,
                               rtol=0, atol=1e-6)


class _RuntimeRecorder:
    """Stands in for the CUDA runtime and the kernel library on the CPU:
    ``device`` is ``torch.cuda.device`` (it sets the current device), and
    every launcher of the library records the current device it is called
    on, as the runtime's launch acts on the current device."""

    def __init__(self):
        self.current = None
        self.launches = []

    @contextlib.contextmanager
    def device(self, dev):
        prev, self.current = self.current, torch.device(dev)
        try:
            yield
        finally:
            self.current = prev

    def __getattr__(self, name):  # the library's symbols
        if name.endswith("_bytes"):
            return lambda *args: 0  # shared memory and scratch queries

        def launch(*args):
            self.launches.append((name, self.current))
            return 0
        return launch


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_LAUNCHES = {
    "ppf_map_stats": lambda: t_stats.map_stats_cuda(
        _meta((2, 16, 16)), 10, True),
    "ppf_attention_block_stats": lambda: t_attn.block_stats_cuda(
        _meta((2, 16, 96), torch.bfloat16), 2, 10, False),
    "ppf_attention_mean": lambda: t_attn.mean_padded_cuda(
        _meta((2, 16, 96)), _meta((2, 16)), 2, 12),
    "ppf_attention_core": lambda: t_attn.core_cuda(_meta((2, 16, 96)),
                                                   None, 2),
}


@pytest.mark.parametrize("symbol", sorted(_LAUNCHES))
def test_every_kernel_launches_under_its_tensors_device(monkeypatch, symbol):
    """A mesh replica's kernels launch on its own card: each wrapper makes
    its tensors' device the current one for the ctypes launch (the runtime
    launches on the current device, whatever the stream's), and restores
    it after. Held here with a recorder in place of the runtime, on meta
    tensors, so that no second card is needed to see the fault."""
    rec = _RuntimeRecorder()
    monkeypatch.setattr(t_build, "library", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(profiling, "_COUNTS", dict(profiling._COUNTS))
    _LAUNCHES[symbol]()
    assert rec.launches == [(symbol, torch.device("meta"))]
    assert rec.current is None


# --- data-parallel training ----------------------------------------------------------

def test_every_trainable_parameter_gets_a_gradient():
    """Why ``find_unused_parameters`` stays off: in every PPNet
    configuration (DeiT and CaiT, with and without the global branch and
    the PPC loss) each parameter that requires a gradient gets one from
    the train step's loss, so DDP's reducer never waits on a missing one."""
    from protopformer_tpu_torch.core.config import backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    # CaiT prunes at a class-attention block (it has 2)
    for arch, prune in (("deit_micro_test", 2), ("cait_micro_test", 1)):
        for use_global in (True, False):
            for ppc in (True, False):
                pp = dataclasses.replace(common.PPNET, use_global=use_global,
                                         use_ppc_loss=ppc,
                                         reserve_layers=(prune,))
                model = construct_ppnet(
                    backbone_preset(arch, drop_path_rate=0.0), pp,
                    generator=torch.Generator().manual_seed(0))
                optim = OptimConfig(epochs=2, warmup_epochs=1,
                                    model_ema=False)
                state = create_train_state(
                    model, make_optimizer(optim, model, 2), with_ema=False,
                    device="cpu")
                seen = {}
                real = state.apply_gradients

                def capture(decay, real=real, seen=seen, model=model):
                    seen.update({n: p.grad is not None
                                 for n, p in model.named_parameters()
                                 if p.requires_grad})
                    return real(decay)

                state.apply_gradients = capture
                step = make_train_step(model, pp, optim, device="cpu")
                step(state, common.local_rows(common.train_index(), 4),
                     torch.Generator().manual_seed(0), 1.0)
                assert seen and all(seen.values()), (arch, use_global, ppc)


def test_mixup_per_rank_shares_lambda_and_differs_from_global_pairing():
    """F11: the port mixes each rank's own rows (row i with local row
    b-1-i) under one lambda and box shared by the ranks (the reference's
    timm Mixup under DDP, with a seed common to the ranks); the JAX step
    pairs global row i with global row B-1-i, which lies on the mirror
    rank. On a batch of 8 split over 2 ranks, under JAX's own draws, the
    port's rows equal a mix of each rank's rows alone and differ in every
    row from the JAX step's global mix; mixing the whole batch in one
    process gives JAX's."""
    from protopformer_tpu.data import mixup as j_mixup
    from tests.test_torch_data import _jax_draws

    rng = np.random.default_rng(2)
    x = rng.uniform(size=(8, 16, 16, 3)).astype(np.float32)
    y = np.array([0, 1, 2, 3, 1, 1, 2, 0], np.int32)
    cfg = dict(mixup_alpha=0.8, cutmix_alpha=0.0, num_classes=4)
    j_mix, mix = j_mixup.MixupCutmix(**cfg), t_mixup.MixupCutmix(**cfg)
    key = jax.random.key(3)
    draws = _jax_draws(j_mix, key, 16, 16)
    assert draws.apply and not draws.use_cutmix
    want = j_mix(key, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    # the ranks draw from one seed, so their draws are one draw
    assert mix.draw(np.random.default_rng((1028, 0, 7)), 16, 16) == \
        mix.draw(np.random.default_rng((1028, 0, 7)), 16, 16)
    halves = [mix.apply({"image": torch.from_numpy(x[r * 4:(r + 1) * 4]),
                         "label": torch.from_numpy(y[r * 4:(r + 1) * 4])},
                        draws) for r in range(2)]
    per_rank = torch.cat([h["image"] for h in halves]).numpy()
    lam = draws.lam
    local = np.concatenate([x[0:4] * lam + x[3::-1] * (1 - lam),
                            x[4:8] * lam + x[7:3:-1] * (1 - lam)])
    np.testing.assert_allclose(per_rank, local, rtol=0, atol=1e-6)
    assert (np.abs(per_rank - np.asarray(want["image"])).reshape(8, -1)
            .max(axis=1) > 1e-3).all()
    labels = torch.cat([h["label"] for h in halves]).numpy()
    assert not np.allclose(labels, np.asarray(want["label"]))
    whole = mix.apply({"image": torch.from_numpy(x),
                       "label": torch.from_numpy(y)}, draws)
    np.testing.assert_allclose(whole["image"].numpy(),
                               np.asarray(want["image"]), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """Two gloo ranks on the CPU, one step with ``clip_grad`` set, the
    evaluation, rank 0's checkpoint; beside them the port's one-process
    step and evaluation, and the JAX step on the global batch."""
    tmp = tmp_path_factory.mktemp("ddp")
    j_bk = BackboneConfig(**dataclasses.asdict(common.BACKBONE))
    params = jax_params(j_bk, common.PPNET, seed=0)
    sd = state_dict_from_jax(params, "deit", j_bk.depth,
                             common.PPNET.global_proto_per_class)
    weights = str(tmp / "weights.pt")
    torch.save(sd, weights)
    optim = dict(epochs=2, warmup_epochs=1, model_ema=False, clip_grad=0.01)
    job = {"weights": weights, "devices": ["cpu", "cpu"], "backend": "gloo",
           "optim": optim, "local_b": 4, "eval_b": 4, "seed": 1028,
           "out": str(tmp / "rank"), "ckpt": str(tmp / "ckpt")}
    outs = common.run_workers(job, tmp)
    ranks = [torch.load(f"{job['out']}.{r}.pt") for r in range(2)]

    # the port's one-process step on the global batch (both shards' rows)
    index = common.train_index()
    parts = [common.local_rows(shard_index_for_process(index, r, 2), 4)
             for r in range(2)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    model, state, step = common.model_and_state(weights,
                                                OptimConfig(**optim), CPU)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0),
                          1.0)
    one = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
           "sums": common.eval_sums(model, common.val_index(), CPU, 8)}
    unclipped = common.model_and_state(
        weights, OptimConfig(**{**optim, "clip_grad": None}), CPU)
    unclipped[2](unclipped[1], batch, torch.Generator().manual_seed(0), 1.0)

    # the JAX step on the same global batch
    from protopformer_tpu.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    j_optim = JOptimConfig(**optim)
    j_model = j_construct(j_bk, common.PPNET)
    j_state = create_train_state(
        params, make_optimizer(j_optim, params, steps_per_epoch=2),
        with_ema=False)
    _, j_metrics = make_train_step(j_model, common.PPNET, j_optim,
                                   donate=False)(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(1), jnp.float32(1.0))
    return dict(outs=outs, ranks=ranks, one=one, jax=j_metrics,
                unclipped=unclipped[0].state_dict(), job=job)


def test_two_process_step_agrees_across_ranks(ddp_run):
    r0, r1 = sorted(ddp_run["outs"], key=lambda r: r["rank"])
    assert r0["is_main"] and not r1["is_main"]
    assert r0["world"] == r1["world"] == 2
    assert r0["backend"] == r1["backend"] == "gloo"
    for k in ("loss", "ce_loss", "ppc_cov_loss", "ppc_mean_loss",
              "train_acc1"):
        assert r0[k] == r1[k], k  # all-reduced: every rank the global value
    p0, p1 = (r["params"] for r in ddp_run["ranks"])
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_two_process_step_matches_the_one_process_step(ddp_run):
    one = ddp_run["one"]
    got = ddp_run["ranks"][0]
    np.testing.assert_allclose(got["metrics"]["loss"], one["metrics"]["loss"],
                               rtol=0, atol=1e-5)
    for k, v in one["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    # the clip ran on the all-reduced gradients: with it the step is
    # another one than without it
    moved = max(float((one["params"][k] - ddp_run["unclipped"][k]).abs()
                       .max()) for k in one["params"])
    assert moved > 1e-6


def test_two_process_step_matches_the_jax_step(ddp_run):
    got = ddp_run["ranks"][0]["metrics"]
    want = ddp_run["jax"]
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["ce_loss"], float(want["ce_loss"]),
                               rtol=1e-5)


def test_two_process_evaluation_counts_each_sample_once(ddp_run):
    one = ddp_run["one"]["sums"]
    for r in ddp_run["ranks"]:
        sums = r["sums"]
        assert sums["n"] == one["n"] == common.EVAL_SAMPLES
        for k in ("correct1", "correct5", "global_correct1",
                  "local_correct1"):
            assert sums[k] == one[k], k
        np.testing.assert_allclose(sums["loss_sum"], one["loss_sum"],
                                   rtol=1e-5)


def test_two_process_checkpoint_loads_into_one_process(ddp_run):
    """Rank 0 saved the inner module: no "module." prefix, and the file
    restores into a one-process state with a strict load."""
    from protopformer_tpu_torch.checkpoint import CheckpointManager

    ckpt = CheckpointManager(ddp_run["job"]["ckpt"])
    assert ckpt.epochs() == [0]
    model, state, _ = common.model_and_state(
        ddp_run["job"]["weights"], OptimConfig(**ddp_run["job"]["optim"]),
        CPU)
    state, meta = ckpt.restore(state)
    assert meta["val_acc1"] == 0.5 and state.step == 1
    saved = ddp_run["ranks"][0]["params"]
    for k, v in model.state_dict().items():
        assert not k.startswith("module.")
        assert torch.equal(v, saved[k]), k


# --- the training CLI under torchrun --------------------------------------------------

MICRO = [*CLI_MICRO, "--epochs=1"]


def test_cli_train_under_torchrun_evaluates_the_full_set_exactly(
        tmp_path, monkeypatch):
    """``torchrun --nproc_per_node=2 -m protopformer_tpu_torch.cli.train``
    over gloo on the CPU (the test's tensorboard import is blocked, as
    ``tests/test_torch_cli.py`` blocks it: it pulls in TensorFlow here):
    rank 0 alone logs and saves; its checkpoint loads into a one-process
    ``--eval --resume``, which reproduces the two ranks' sharded
    evaluation of the 64 samples: acc1 exactly, the loss within 1e-6."""
    import signal

    from protopformer_tpu_torch.cli import train as t_train_cli

    out = tmp_path / "run"
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(site), ROOT,
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "--master_addr=localhost", f"--master_port={common.free_port()}",
         "-m", "protopformer_tpu_torch.cli.train", *MICRO,
         f"--output_dir={out}", "--device=cpu", "--dist_backend=gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT, process_group=0)
    try:
        stdout, stderr = proc.communicate(timeout=common.WORKER_LIMIT_S)
    finally:
        if proc.poll() is None:  # the launcher and both ranks
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    assert "2 ranks over gloo" in stderr
    assert os.listdir(out / "checkpoints") == ["checkpoint-0.pth"]
    with open(out / "metrics.jsonl") as f:
        epochs = [json.loads(line) for line in f
                  if "epoch/val_acc1" in line]
    assert len(epochs) == 1  # rank 0 alone writes
    # 64 samples, a global batch of 8: 4 a rank, 8 steps an epoch
    assert sum(1 for line in open(out / "metrics.jsonl")
               if "train/loss" in line) == 8

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    stats = t_train_cli.main(t_train_cli.get_args_parser().parse_args(
        [*MICRO, "--eval", f"--resume={out}/checkpoints/checkpoint-0.pth",
         f"--output_dir={tmp_path / 'eval'}", "--device=cpu"]))
    assert stats["acc1"] == epochs[0]["epoch/val_acc1"]
    np.testing.assert_allclose(stats["loss"], epochs[0]["epoch/val_loss"],
                               rtol=0, atol=1e-6)
