from protopformer_tpu_torch.train.loop import (
    NonFiniteLossError,
    evaluate,
    train_one_epoch,
)
from protopformer_tpu_torch.train.optimizer import (
    GroupOptimizer,
    make_optimizer,
    param_group_label,
)
from protopformer_tpu_torch.train.scheduler import (
    cosine_epoch_schedule,
    make_group_schedules,
    step_epoch_schedule,
)
from protopformer_tpu_torch.train.state import TrainState, create_train_state
from protopformer_tpu_torch.train.steps import (
    cross_entropy_loss,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "GroupOptimizer",
    "NonFiniteLossError",
    "TrainState",
    "create_train_state",
    "cosine_epoch_schedule",
    "cross_entropy_loss",
    "evaluate",
    "make_eval_step",
    "make_group_schedules",
    "make_optimizer",
    "make_train_step",
    "param_group_label",
    "step_epoch_schedule",
]
