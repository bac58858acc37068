"""CPU tests of the benchmark: one PyTorch thread a process, as the
repository's own tests run under several workers."""

import torch

torch.set_num_threads(1)
