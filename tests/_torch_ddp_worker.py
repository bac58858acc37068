"""Worker of the port's two-process data-parallel tests
(``tests/test_torch_parallel.py``). It imports no JAX.

Run as: python tests/_torch_ddp_worker.py <rank> <world> <port> <job.json>

The job file names the weights (a state dict saved by the parent), each
rank's device, the backend and the options. Each rank joins the group
(``initialize_multihost``), takes its rows of the global batch (its
``shard_index_for_process`` of a seeded synthetic index, first
``local_b`` samples, as ``tests/_mp_worker.py`` takes them), runs one
data-parallel train step (``make_train_step(distributed=True)``), then
evaluates its shard of a second index whose size does not split evenly
(``make_eval_step(distributed=True)``). With ``ckpt`` in the job, rank 0
saves the state there after the step. It writes its metrics, its
evaluation sums, its parameters after the step and its gradients into
``<out>.<rank>.pt`` and prints one JSON line.
"""

import json
import sys


def main() -> None:
    rank, world, port, job_path = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    with open(job_path) as f:
        job = json.load(f)
    import numpy as np
    import torch

    from protopformer_tpu_torch.core.config import OptimConfig
    from protopformer_tpu_torch.parallel import (
        barrier,
        initialize_multihost,
        is_main_process,
        process_count,
        shard_index_for_process,
    )

    torch.set_num_threads(1)
    dev = torch.device(job["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world == 1:
        # a group of one (an NCCL world on a one-card machine): the
        # helper leaves one process alone, so join it here
        torch.distributed.init_process_group(
            job["backend"], init_method=f"tcp://localhost:{port}",
            world_size=1, rank=0)
    else:
        initialize_multihost(f"localhost:{port}", world, rank,
                             backend=job["backend"])
    from tests.torch_ddp_common import (
        eval_sums,
        local_rows,
        model_and_state,
        train_index,
        val_index,
    )

    optim = OptimConfig(**job["optim"])
    model, state, step = model_and_state(job["weights"], optim, dev,
                                         distributed=True)
    batch = local_rows(shard_index_for_process(train_index()),
                       job["local_b"])
    gen = torch.Generator(dev).manual_seed(job["seed"] + rank)
    state, metrics = step(state, batch, gen, 1.0)
    metrics = {k: float(v) for k, v in metrics.items()}
    if job.get("ckpt"):
        # rank 0 saves the inner module (no "module." prefix), between
        # barriers, as cli.train does
        from protopformer_tpu_torch.checkpoint import CheckpointManager

        barrier()
        if is_main_process():
            CheckpointManager(job["ckpt"]).save(0, state, {"val_acc1": 0.5})
        barrier()
    sums = eval_sums(model, shard_index_for_process(val_index()), dev,
                     job["eval_b"], distributed=True)
    torch.save({"metrics": metrics, "sums": sums,
                "params": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
                "grads": {k: p.grad.detach().cpu()
                          for k, p in model.named_parameters()
                          if p.grad is not None}},
               f"{job['out']}.{rank}.pt")
    print(json.dumps({"rank": rank, "world": process_count(),
                      "is_main": is_main_process(),
                      "backend": torch.distributed.get_backend(),
                      **metrics}))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
