"""Training: the program's train step (``train.make_train_step``) on
device-resident seeded batches, one step after another.

Set-up makes the weights (on the device, from the seed), builds one train
state (the PPNet, its three-group optimizer at the configuration's
schedule, set to ``start_step``, and the EMA copy) and one train step, and
makes a pool of ``pool_batches`` batches on the device: images in [0, 1]
NHWC, as the data loader hands them over, and integer labels. It then
drives that state through its first ``checked_steps`` steps, on pool
batches whose rows all differ, through the same call the window makes,
and keeps what ``correct`` compares: each leaf's first gradient (read
back from AdamW's first moment, ``(1 - beta1) g`` after one step) and the
parameters after the checked steps, with each step's loss beside them. The window
then goes on with that same state, cycling through the pool, and ends in
a synchronize. Stochastic depth draws from one generator on the device,
seeded from the run's seed.

``correct``: once the window has closed, the plain reference takes the
same weights, batches and stochastic-depth generator seed through the
checked steps (``reference.train.train_steps``) and the two are compared
(``compare.train_numbers``).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import compare, harness, trace, weights
from benchmark.reference import train as reference


def optim_config(optim: dict):
    """The program's ``OptimConfig`` for a configuration file's optimizer."""
    from protopformer_tpu_torch.core.config import OptimConfig

    wd, lr = optim["weight_decay"], optim["lr"]
    if wd["features"] != wd["add_on"]:
        raise ValueError("the program gives the features and add-on groups "
                         "one weight decay")
    return OptimConfig(
        opt=optim["opt"], opt_eps=optim["eps"],
        opt_betas=tuple(optim["betas"]), weight_decay=wd["prototypes"],
        group_weight_decay=wd["features"], features_lr=lr["features"],
        add_on_layers_lr=lr["add_on"], prototype_vectors_lr=lr["prototypes"],
        sched=optim["sched"], epochs=optim["epochs"],
        warmup_epochs=optim["warmup_epochs"], warmup_lr=optim["warmup_lr"],
        min_lr=optim["min_lr"], model_ema=optim["model_ema"],
        model_ema_decay=optim["model_ema_decay"])


class Driver:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.cfg = harness.model_cfg(ctx.cell.config, "train")
        self.optim = ctx.cell.config["train"]["optim"]
        self.traffic = ctx.cell.traffic
        self.state = None

    def _batches(self):
        t, dev = self.traffic, self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(
            weights.sub_seed(self.ctx.seed, "batches"))
        size, b = self.cfg["img_size"], t["batch_size"]
        return [{"image": torch.rand((b, size, size, 3), generator=gen,
                                     device=dev),
                 "label": torch.randint(0, self.cfg["num_classes"], (b,),
                                        generator=gen, device=dev)}
                for _ in range(t["pool_batches"])]

    def _drop_path_generator(self) -> torch.Generator:
        return torch.Generator(device=self.ctx.device).manual_seed(
            weights.sub_seed(self.ctx.seed, "drop_path"))

    def setup(self) -> None:
        from protopformer_tpu_torch import train
        from protopformer_tpu_torch.models import construct_ppnet

        dev = self.ctx.device
        self.sd = weights.state_dict(self.cfg, self.ctx.seed, dev)
        backbone, ppnet, dtype = harness.port_configs(self.ctx.cell.config,
                                                      "train")
        ocfg = optim_config(self.optim)
        model = construct_ppnet(backbone, ppnet, dtype)
        model.load_state_dict(self.sd, strict=True)
        self.state = train.create_train_state(
            model, train.make_optimizer(ocfg, model,
                                        self.optim["steps_per_epoch"]),
            with_ema=ocfg.model_ema, device=dev)
        self.state.step = self.optim["start_step"]
        self.step = train.make_train_step(model, ppnet, ocfg, device=dev)
        self.pool = self._batches()
        self.generator = self._drop_path_generator()
        self.next_batch = 0

        params = dict(model.named_parameters())
        adam = self.state.optimizer.optimizer
        beta1 = self.optim["betas"][0]
        self.losses = []
        for i in range(self.traffic["checked_steps"]):
            metrics = self._step()
            self.losses.append(float(metrics["loss"]))
            if i == 0:
                self.first_grads = {
                    k: adam.state[p]["exp_avg"] / (1.0 - beta1)
                    if p in adam.state else torch.zeros_like(p)
                    for k, p in params.items() if p.requires_grad}
        self.checked_params = {k: params[k].detach().clone()
                               for k in self.first_grads}
        harness.synchronize(dev)

    def _step(self):
        batch = self.pool[self.next_batch % len(self.pool)]
        self.next_batch += 1
        return self.step(self.state, batch, self.generator, 1.0)[1]

    def window(self) -> dict:
        spans, steps = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.ctx.seconds:
            start = time.perf_counter()
            self._step()
            spans.append(time.perf_counter() - start)
            steps += 1
        harness.synchronize(self.ctx.device)
        window_s = time.perf_counter() - t0
        images = steps * self.traffic["batch_size"]
        return {"metrics": {"train_img_per_s": images / window_s},
                "attempted": steps, "failed": 0,
                "quartiles_s": harness.quartiles(spans),
                "record": {"images": images, "window_s": window_s,
                           "steps": steps, "step_spans_s": spans}}

    def trace(self) -> dict:
        from protopformer_tpu_torch import kernels

        kernels.reset_launch_counts()
        out = trace.trace_slice(
            lambda: [self._step() for _ in range(self.traffic["trace_steps"])],
            lambda: harness.synchronize(self.ctx.device))
        out["launches"] = kernels.launch_counts()
        out["steps"] = self.traffic["trace_steps"]
        return out

    def release(self) -> None:
        self.state = self.step = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        n = self.traffic["checked_steps"]
        batches = [(b["image"], b["label"]) for b in self.pool[:n]]
        ref = reference.train_steps(self.sd, self.cfg, self.optim, batches,
                                    self._drop_path_generator())
        self.readings = compare.train_readings(self.losses, ref)
        return compare.train_numbers(self.first_grads, self.checked_params,
                                     ref, self.sd)
