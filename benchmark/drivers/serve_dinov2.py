"""Serving a PPNet over a DINOv2 backbone with registers: ``serve.py``'s
driver (its one closed-loop client, set-up, window, traced slice and
release) with four things replaced: the weights (``weights_dinov2``: the
DINOv2 layout), the plain reference (``reference/dinov2.py``), the
compared numbers (``compare_cait``'s ``logit_err`` and ``keep_miss``) and
the sample: ``check_images`` images of the longest request that
``serve.Driver.sample`` draws first, in equal shares from the head of
each of its chunks, so that every chunk's staging, buffers and offsets are
checked while the reference's float32 forward of the giant backbone,
about a second for every 16 images, runs on no more images than that.

``serve.py`` is loaded by its path as a private copy of the module, whose
``weights``, ``reference`` and ``compare`` are then these; the serving
cells' own copies of it are untouched."""

from __future__ import annotations

from pathlib import Path

from benchmark import compare_cait, harness, weights_dinov2
from benchmark.reference import dinov2

_serve = harness.load_module(Path(__file__).with_name("serve.py"))
_serve.weights = weights_dinov2
_serve.reference = dinov2


class Driver(_serve.Driver):
    """``serve.Driver`` on DINOv2 weights, checked against the DINOv2
    reference on ``check_images`` images taken from every chunk of one
    request."""

    def sample(self):
        offset, size, res = super().sample()[0]
        chunks = -(-size // self.batch)
        share = self.traffic["check_images"] // chunks
        picked = []
        for lo in range(0, size, self.batch):
            rows = slice(lo, lo + min(share, size - lo))
            picked.append((offset + lo, rows.stop - lo, res._replace(
                logits=res.logits[rows], top_class=res.top_class[rows],
                cls_token_attn=(None if res.cls_token_attn is None
                                else res.cls_token_attn[rows]))))
        return picked

    def check(self):
        _serve.compare = compare_cait.for_config(self.cfg)
        return super().check()
