"""ProtoPFormer on PyTorch and CUDA (an NVIDIA H100, sm_90a).

A port of ``protopformer_tpu`` (the JAX package, kept as the reference):
the PPNet eval forward over the pruning DeiT backbone and its serving
engine, with the JAX package's Pallas kernels rewritten as CUDA C++ kernels
in ``csrc/``. The package imports ``torch`` and ``numpy``, never ``jax`` or
the JAX package.
"""

__version__ = "0.1.0"
