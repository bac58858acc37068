"""Readings for the limits of a CaiT serving cell, on the card:

    python3 -m benchmark.controls_cait --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--seconds 2]

``controls.py``'s ``main`` (a private copy of the module) with the CaiT
reference (``reference/cait.py``) in place of the DeiT one and the CaiT
cell's compared numbers (``compare_cait``), with ``attn_err`` recorded
beside them: the program's readings on every seed and, on the first
``--control-seeds``, the fp8 reference and the program's scores handed to
another image. The int8 reading is left out: the program's CaiT blocks
take no ``quantize`` option, so its "int8" engine (which ``controls.py``
builds and runs all the same) would be the bf16 one again. One JSON line a
seed. The benchmark's runs do not run this.
"""

from __future__ import annotations

from benchmark import compare_cait, harness
from benchmark.reference import cait

_controls = harness.load_module(harness.BENCH / "controls.py")
_controls.reference = cait
_serve_controls = _controls.serve_controls


def serve_controls(driver):
    _controls.compare = compare_cait.for_config(driver.cfg,
                                                   record_attn_err=True)
    out = _serve_controls(driver)
    out.pop("int8")
    return out


_controls.serve_controls = serve_controls


def main(argv=None) -> int:
    return _controls.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
