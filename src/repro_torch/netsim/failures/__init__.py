"""Hard-failure subsystem: link and site outage timelines for the engine.

A ``FailureSchedule`` holds per-edge ``(down_at_us, up_at_us)`` windows in
which a link is dead. Compiled into ``NetConfig.failure_schedule`` it rides
into the step as ``NetParams.fail_windows`` (``[B, L, W, 2]``; the window
count W is static). In the step (``fluid.make_step_fn``):

  * a dead link's capacity is zeroed: nothing new launches onto it;
  * bytes reaching the far end of a dead link are dumped into the engine's
    loss-repair path, so byte conservation holds through the outage and the
    data is sent again over the links that survive;
  * schemes see the per-step mask ``SchemeCtx.link_live`` and re-spray over
    the survivors, stalling (never going NaN) when every link is down.

An all-up schedule (windows that never fire) is bit-equal to no schedule.
"""
from repro_torch.netsim.failures.schedule import (
    FailureSchedule,
    load_failure_json,
    save_failure_json,
)

__all__ = [
    "FailureSchedule",
    "load_failure_json",
    "save_failure_json",
]
