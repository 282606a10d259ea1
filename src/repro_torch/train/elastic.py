"""Elastic scaling, failure recovery and straggler mitigation: the port of
``repro.train.elastic``.

  * ``resharding_plan``  -- the mesh to run on after losing pods or data-axis
                            rows, with the batch and LR rescaling rules;
  * ``FailureRecovery``  -- wraps the train loop: on failure, go back to the
                            latest checkpoint's step and replay; bounded
                            restarts.
  * ``StragglerMonitor`` -- per-step deadline from a running p50; flags
                            persistent stragglers for replica eviction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.config.base import ParallelConfig


@dataclass(frozen=True)
class ReshardingPlan:
    old_mesh: tuple
    new_mesh: tuple
    batch_scale: float        # keep the global batch (1.0) or scale it down
    lr_scale: float           # linear-scaling rule when the batch changes
    reason: str


def resharding_plan(par: ParallelConfig, *, lost_pods: int = 0, lost_data_rows: int = 0,
                    keep_global_batch: bool = True) -> ReshardingPlan:
    """The mesh to run on after losing pods / data-axis rows. The model axis
    is never shrunk (parameter shards would be lost: a failure inside a
    model-axis group restarts the group from a checkpoint)."""
    old = par.mesh_shape()
    pods = (par.pods if par.multi_pod else 1) - lost_pods
    data = par.data - lost_data_rows
    if pods < 1 or data < 1:
        raise ValueError("cannot reshard below one pod / one data row")
    new = (pods, data, par.model) if par.multi_pod else (data, par.model)
    frac = (pods * data) / ((par.pods if par.multi_pod else 1) * par.data)
    scale = 1.0 if keep_global_batch else frac
    return ReshardingPlan(old_mesh=old, new_mesh=new, batch_scale=scale, lr_scale=scale,
                          reason=f"lost_pods={lost_pods} lost_rows={lost_data_rows}")


@dataclass
class StragglerMonitor:
    """Deadline policy: a step slower than ``factor`` x running-p50 is a
    straggler event; ``evict_after`` consecutive events on the same replica
    triggers eviction."""
    factor: float = 3.0
    evict_after: int = 3
    window: int = 50
    _times: List[float] = field(default_factory=list)
    _consecutive: int = 0

    def observe(self, step_time_s: float) -> str:
        """Returns 'ok' | 'straggler' | 'evict'."""
        self._times.append(step_time_s)
        self._times = self._times[-self.window:]
        if len(self._times) < 5:
            return "ok"
        med = sorted(self._times)[len(self._times) // 2]
        if step_time_s > self.factor * med:
            self._consecutive += 1
            if self._consecutive >= self.evict_after:
                self._consecutive = 0
                return "evict"
            return "straggler"
        self._consecutive = 0
        return "ok"


class FailureRecovery:
    """Bounded-restart train-loop wrapper with checkpoint replay.

    It catches any exception and replays, so a fault that fails once goes
    unseen unless ``restarts`` is read: a caller that must see every fault
    checks ``restarts == 0``.

    ``restore(step)``, where given, loads checkpoint ``step`` back into the
    state that ``train_fn`` updates in place, before the replay from it. With
    ``restore`` a failure that has no checkpoint to go back to is raised, since
    a replay from the start would begin on state that the failed steps changed.
    Without it the replay starts on whatever state ``train_fn`` keeps, as the
    JAX package's does."""

    def __init__(self, ckpt_manager, max_restarts: int = 3,
                 restore: Optional[Callable[[int], None]] = None):
        self.ckpt = ckpt_manager
        self.max_restarts = max_restarts
        self.restore = restore
        self.restarts = 0

    def run(self, train_fn: Callable[[int], int], start_step: int,
            total_steps: int) -> int:
        """``train_fn(start) -> last_step`` runs until done or raises.
        Returns the final step."""
        step = start_step
        while step < total_steps:
            try:
                step = train_fn(step)
            except Exception as e:  # noqa: BLE001 -- any worker failure
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                latest = self.ckpt.latest_step()
                if self.restore is not None:
                    if latest is None:
                        raise
                    self.restore(latest)
                step = start_step if latest is None else latest
        return step
