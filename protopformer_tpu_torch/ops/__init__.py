"""Numeric ops of the pruning forward (ports of ``protopformer_tpu/ops``)."""
