from protopformer_tpu_torch.utils.logging import MetricWriter, get_logger
from protopformer_tpu_torch.utils.metrics import MetricLogger, SmoothedValue
from protopformer_tpu_torch.utils.seeding import set_seed

__all__ = ["MetricLogger", "MetricWriter", "SmoothedValue", "get_logger",
           "set_seed"]
