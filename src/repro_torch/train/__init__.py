"""Training on one device: optimizer, train step, data, checkpoints, recovery."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.elastic import FailureRecovery, StragglerMonitor
from repro_torch.train.optimizer import (
    AdamState, adam_update, clip_by_global_norm, global_norm, init_adam, lr_schedule,
)
from repro_torch.train.train_step import train_step, value_and_grad

__all__ = [
    "CheckpointManager", "SyntheticDataset", "FailureRecovery", "StragglerMonitor",
    "AdamState", "adam_update", "clip_by_global_norm", "global_norm", "init_adam",
    "lr_schedule", "train_step", "value_and_grad",
]
