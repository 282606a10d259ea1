"""Training: optimizer, train steps (one device, and on a mesh), data,
checkpoints, recovery, resharding plans."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.elastic import (
    FailureRecovery, ReshardingPlan, StragglerMonitor, resharding_plan,
)
from repro_torch.train.optimizer import (
    AdamState, adam_update, clip_by_global_norm, global_norm, init_adam, lr_schedule,
)
from repro_torch.train.train_step import (
    batch_specs, make_train_step, train_step, value_and_grad,
)

__all__ = [
    "CheckpointManager", "SyntheticDataset", "FailureRecovery", "StragglerMonitor",
    "AdamState", "adam_update", "clip_by_global_norm", "global_norm", "init_adam",
    "lr_schedule", "train_step", "value_and_grad", "batch_specs", "make_train_step",
    "ReshardingPlan", "resharding_plan",
]
