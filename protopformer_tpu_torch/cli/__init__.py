"""Command-line entry points of the port (``python -m
protopformer_tpu_torch.cli.<name>``)."""
