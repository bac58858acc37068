"""Readings for the limits of the DINOv2 serving cell, on the card:

    python3 -m benchmark.controls_dinov2 --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--seconds 2]

``controls.py``'s ``main`` (a private copy of the module) with the DINOv2
reference (``reference/dinov2.py``) in place of the DeiT one and the
cell's compared numbers (``compare_cait``: ``logit_err`` and
``keep_miss``), with ``attn_err`` recorded beside them: the program's
readings on every seed and, on the first ``--control-seeds``, the fp8
reference, the program's own int8 path and the program's scores handed to
another image. One JSON line a seed. The benchmark's runs do not run
this.
"""

from __future__ import annotations

from benchmark import compare_cait, harness
from benchmark.reference import dinov2

_controls = harness.load_module(harness.BENCH / "controls.py")
_controls.reference = dinov2
_serve_controls = _controls.serve_controls


def serve_controls(driver):
    _controls.compare = compare_cait.for_config(driver.cfg,
                                                record_attn_err=True)
    return _serve_controls(driver)


_controls.serve_controls = serve_controls


def main(argv=None) -> int:
    return _controls.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
