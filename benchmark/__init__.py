"""The benchmark of ``protopformer_tpu_torch`` on the card: cells of a
configuration (``configs/``) under a traffic mix (``traffic/``) run by the
mix's driver (``drivers/``), per-layer metrics read by ``metrics/``, counts
in ``counts/``, the plain reference in ``reference/``. The entry point is
``python3 -m benchmark.run``; ``BENCHMARK.json`` at the checkout's root
names the cells and metrics."""
