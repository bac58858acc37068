from protopformer_tpu_torch.utils.metrics import MetricLogger, SmoothedValue

__all__ = ["MetricLogger", "SmoothedValue"]
