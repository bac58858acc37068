"""Serving: one closed-loop client calls ``ServingEngine.__call__`` on host
uint8 images and waits for the numpy answer before it sends the next.

Set-up makes the weights (on the device, from the seed), the engine (it
folds the normalization into the patch embedding and loads the weights)
and the host image pool, and serves one request of the mix's largest size
so that every kernel is built and every buffer made. The window sends
whole requests until ``--seconds`` have passed; each latency runs from the
call to the returned numpy result. The traced slice serves the mix's next
``trace_requests`` requests under the profiler.

``correct``: once the window has closed, a sample of the finished requests
drawn from the seed, the longest first, until ``check_images`` images, is
run through the plain reference on the same images and weights and
compared (``compare.serve_numbers``): the logits, and the rollout scores
where the mix asks for them.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import arrivals, compare, harness, trace, weights
from benchmark.reference import ppnet as reference


class Driver:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.cfg = harness.model_cfg(ctx.cell.config, "serve")
        self.traffic = ctx.cell.traffic
        self.engine = None

    def setup(self) -> None:
        from protopformer_tpu_torch.serving import ServingEngine

        ctx, t = self.ctx, self.traffic
        dev = ctx.device
        self.sd = weights.state_dict(self.cfg, ctx.seed, dev)
        backbone, ppnet, dtype = harness.port_configs(ctx.cell.config, "serve")
        self.batch = ctx.cell.config["serve"]["batch_size"]
        self.engine = ServingEngine(backbone, ppnet, self.sd,
                                    batch_size=self.batch, compute_dtype=dtype,
                                    with_attn=t["with_attn"], device=dev)
        self.pool = weights.uint8_images(t["pool_images"], self.cfg["img_size"],
                                         ctx.seed, dev)
        self.stream = arrivals.requests(t, ctx.seed)
        self.engine(self.pool[:t["sizes"][1]])
        harness.synchronize(dev)

    def _serve(self, offset: int, size: int):
        return self.engine(self.pool[offset:offset + size])

    def window(self) -> dict:
        served, latencies = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.ctx.seconds:
            offset, size = next(self.stream)
            start = time.perf_counter()
            res = self._serve(offset, size)
            latencies.append(time.perf_counter() - start)
            served.append((offset, size, res))
        window_s = time.perf_counter() - t0
        self.served = served
        images = sum(size for _, size, _ in served)
        failed = sum(1 for _, size, res in served
                     if res.logits.shape != (size, self.cfg["num_classes"])
                     or not np.isfinite(res.logits).all())
        return {
            "metrics": {"serve_img_per_s": images / window_s,
                        "serve_p95_ms": float(np.percentile(latencies, 95))
                        * 1e3},
            "attempted": len(served), "failed": failed,
            "quartiles_s": harness.quartiles(latencies),
            "record": {"images": images, "window_s": window_s,
                       "requests": len(served), "chunk": self.batch},
        }

    def trace(self) -> dict:
        from protopformer_tpu_torch import kernels

        reqs = [next(self.stream)
                for _ in range(self.traffic["trace_requests"])]
        kernels.reset_launch_counts()
        out = trace.trace_slice(lambda: [self._serve(*r) for r in reqs],
                                lambda: harness.synchronize(self.ctx.device))
        out["launches"] = kernels.launch_counts()
        out["chunks"] = sum(-(-size // self.batch) for _, size in reqs)
        return out

    def release(self) -> None:
        self.engine = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """The finished requests to compare, drawn from the seed: a longest
        one first, then others until ``check_images`` images."""
        rng = np.random.default_rng(weights.sub_seed(self.ctx.seed, "check"))
        sizes = np.array([size for _, size, _ in self.served])
        longest = rng.choice(np.flatnonzero(sizes == sizes.max()))
        order = [int(longest)] + [int(i) for i in rng.permutation(len(sizes))
                                  if i != longest]
        picked, images = [], 0
        for i in order:
            if images >= self.traffic["check_images"]:
                break
            picked.append(self.served[i])
            images += sizes[i]
        return picked

    def check(self) -> Dict[str, float]:
        rows = self.ctx.cell.config["serve"]["reference_rows"]
        worst: Dict[str, float] = {}
        for offset, size, res in self.sample():
            imgs = torch.from_numpy(self.pool[offset:offset + size]).to(
                self.ctx.device)
            ref = reference.serve_logits(self.sd, self.cfg, imgs, rows)
            nums = compare.serve_numbers(
                res.logits, ref["logits"], res.cls_token_attn,
                ref["cls_token_attn"])
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
        return worst
