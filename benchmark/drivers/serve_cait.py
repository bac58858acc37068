"""Serving a PPNet over a CaiT backbone: ``serve.py``'s driver (its one
closed-loop client, set-up, window, traced slice, sample and release) with
three things replaced: the weights (``weights_cait``: the CaiT layout),
the plain reference (``reference/cait.py``) and the compared numbers
(``compare_cait``: ``logit_err`` and ``keep_miss``).

``serve.py`` is loaded by its path as a private copy of the module, whose
``weights``, ``reference`` and ``compare`` are then these; the serving
cells' own copies of it are untouched."""

from __future__ import annotations

from pathlib import Path

from benchmark import compare_cait, harness, weights_cait
from benchmark.reference import cait

_serve = harness.load_module(Path(__file__).with_name("serve.py"))
_serve.weights = weights_cait
_serve.reference = cait


class Driver(_serve.Driver):
    """``serve.Driver`` on CaiT weights, checked against the CaiT
    reference."""

    def check(self):
        _serve.compare = compare_cait.for_config(self.cfg)
        return super().check()
