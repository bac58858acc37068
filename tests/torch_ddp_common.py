"""What the port's data-parallel worker (``tests/_torch_ddp_worker.py``)
and its one-process reference share: the micro geometry of
``tests/_mp_worker.py``, its seeded synthetic data, the model and train
state on a device, and the evaluation sums. It imports no JAX."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from protopformer_tpu_torch.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu_torch.data.datasets import build_synthetic_index
from protopformer_tpu_torch.data.loader import HostDataLoader
from protopformer_tpu_torch.models import construct_ppnet
from protopformer_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

# tests/_mp_worker.py's geometry but for the prune point: drop rates 0, so
# a rank's generator (seed + rank) draws nothing that a one-process step
# would draw otherwise. Its prune at block 1 ranks the patches on ONE
# block's map, whose CLS row keeps fewer than 9 non-zero scores, so the
# top-9 holds tied zeros that the two frameworks break differently (trap
# F2); 3 blocks pruning at block 2 under discard 0.7 (test_torch_model.py's
# geometry) keep the top-9 tie-free
BACKBONE = BackboneConfig(
    name="mp-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, drop_path_rate=0.0,
    rollout_discard_ratio=0.7,
)
PPNET = PPNetConfig(
    prototype_shape=(8, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=2, use_ppc_loss=True,
)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_LIMIT_S = 240  # a hard limit on every worker process
EVAL_SAMPLES = 11  # splits over 2 ranks as 6 + 6 with one wrapped duplicate


def train_index():
    return build_synthetic_index(num_samples=16, num_classes=4,
                                 image_size=32)


def val_index():
    return build_synthetic_index(num_samples=EVAL_SAMPLES, num_classes=4,
                                 image_size=32, seed=5)


def local_rows(index, n):
    """The first ``n`` samples of an index as a [0, 1] batch, as
    ``tests/_mp_worker.py::local_slice`` decodes them."""
    return {"image": index.images[:n].astype(np.float32) / 255.0,
            "label": index.labels[:n].astype(np.int32)}


def model_and_state(weights, optim, device, distributed=False):
    """The micro PPNet in fp32 with the saved weights, its train state
    (AdamW in three groups, no EMA) and its train step."""
    model = construct_ppnet(BACKBONE, PPNET, torch.float32)
    model.load_state_dict(torch.load(weights), strict=True)
    tx = make_optimizer(optim, model, steps_per_epoch=2)
    state = create_train_state(model, tx, with_ema=False, device=device)
    step = make_train_step(model, PPNET, optim, device=device,
                           distributed=distributed)
    return model, state, step


def eval_sums(model, index, device, batch_size, distributed=False):
    """The eval step's sums over an index through ``HostDataLoader`` (the
    last batch padded; padding and an index's invalid samples count 0)."""
    step = make_eval_step(PPNET.use_global, device=device,
                          distributed=distributed)
    loader = HostDataLoader(index, lambda img, rng: img.astype(np.float32)
                            / 255.0, batch_size, shuffle=False,
                            num_workers=1)
    totals = {}
    for batch in loader:
        for k, v in step(model, batch).items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return totals


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(job: dict, tmp_path, world: int = 2) -> list:
    """Start ``world`` processes of ``tests/_torch_ddp_worker.py`` on one
    job and wait for all of them within ``WORKER_LIMIT_S``; on expiry every
    worker is killed. Returns each worker's JSON line."""
    job_path = tmp_path / "job.json"
    job_path.write_text(json.dumps(job))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("WORLD_SIZE", None)
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_ddp_worker.py"),
         str(r), str(world), port, str(job_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=WORKER_LIMIT_S)
            assert p.returncode == 0, f"worker failed:\n{stderr[-3000:]}"
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
