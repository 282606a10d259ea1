"""The port's side of tests/test_grad.py's harness: the soft-step engine's
surrogate (``netsim.grad_tune.surrogate_from_sums``, the per-cell objective
``_harness`` builds there) over a batch of tests/test_grad.py's base point,
and its gradient with respect to every leaf of the batch's NetParams and
WorkloadParams through ``torch.autograd``.

Not a test module (pytest collects ``test_*.py`` only); it imports no JAX.
"""
import numpy as np
import torch

from repro_torch.config.net import NetConfig, batch_template, stack_net_params
from repro_torch.netsim import fluid, grad_tune
from repro_torch.netsim.workload import (
    WorkloadParams, as_workload_batch, throughput_workload,
)

# tests/test_grad.py's BASE: 96 km (96 delay steps, off the rounding
# boundaries), slot_us 112 (22.4 steps a slot), soft_temp 0.3, the impairment
# knobs engaged
BASE = dict(distance_km=96.0, slot_us=112.0, horizon_us=4000.0,
            soft_step=True, soft_temp=0.3,
            loss_rate=0.01, loss_burst_len=4.0, jitter_us=20.0,
            flap_period_us=1000.0, flap_depth=0.3)
# the workload leaves that are discrete (flow kind, mask, routing, sites):
# their gradient is held finite only, as tests/test_grad.py's FD battery
# exempts them
DISCRETE_WL = ("is_inter", "active_mask", "route", "src_site", "dst_site")


def workload():
    return throughput_workload(8e6, 4, num_flows=4)


def batch(b=1, **over):
    """``(template, steps, warm, delay_pad, history_slots, params, wlp)`` of
    ``b`` copies of BASE with ``over``: numpy leaves, to perturb."""
    cfg = NetConfig(**{**BASE, **over})
    tmpl = batch_template([cfg])
    steps = tmpl.horizon_steps(None)
    dp, hs = fluid.batch_padding([cfg])
    params = stack_net_params([cfg] * b)
    wlp = as_workload_batch(workload(), b)
    return (tmpl, steps, int(steps * fluid.WARMUP_FRAC), dp, hs,
            [v.numpy().copy() for v in params], [np.asarray(v).copy() for v in wlp])


def objective(tmpl, steps, warm, dp, hs, params, wlp, scheme, channel=None):
    """Per-cell surrogate ``[B]`` of a ``batch`` (tests/test_grad.py's
    ``objvec``), no gradient."""
    from repro_torch.config.net import NetParams
    _, acc = fluid.run_traced_batch(
        tmpl, NetParams(*(torch.tensor(v) for v in params)),
        WorkloadParams(*(torch.tensor(np.asarray(v, np.float32)) for v in wlp)),
        scheme, steps, 0, dp, hs, mode="metrics", warm=warm, channel=channel)
    return grad_tune.cell_surrogates(fluid.acc_columns(acc)["sum_s"],
                                     max(steps - warm, 1)).numpy()


def grads(scheme, channel=None, **over):
    """``(surrogate, {"net": {name: ndarray}, "wl": {name: ndarray}})`` of
    one BASE cell with ``over``: the gradient of every leaf
    (``netsim.grad_tune.surrogate_grads``)."""
    surr, gp, gw = grad_tune.surrogate_grads([NetConfig(**{**BASE, **over})],
                                             workload(), scheme, channel=channel,
                                             device="cpu")
    return float(surr[0]), {"net": {k: v.numpy() for k, v in zip(gp._fields, gp)},
                         "wl": {k: v.numpy() for k, v in zip(gw._fields, gw)}}
