"""Single soft steps of the port against the JAX package's, teacher-forced:
JAX's state before a step loaded into the port, one step on each side, for
the seven schemes on the ideal channel and on ``impaired`` at
tests/test_grad.py's base point (96 km, slot_us 112, soft_temp 0.3, the
impairment knobs engaged), cut to 303 steps.

  * values: the new state and the step's traces within ``STEP_REL`` (1e-6) of
    each leaf's largest value over the run (``worst_step_errors``);
  * one step's VJP: the gradient of a random read of the new state and the
    traces, each leaf weighed by 1 / its scale, with respect to the state,
    every NetParams leaf and every WorkloadParams leaf, from ``jax.grad`` and
    from ``torch.autograd``, within ``STEP_REL`` of the larger of each
    leaf's magnitude and 1e-5 of the step's largest gradient x scale over
    the leaf's scale (``step_vjp_errors``).
"""
import pytest

from repro.config.base import NetConfig as JNetConfig
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import workload as pwork
from torch_netsim_jax import (
    STEP_REL, jax_states, over_step_limits, port_step, step_vjp_errors,
    worst_step_errors,
)
from torch_parity import ALL_SCHEMES

BASE = dict(distance_km=96.0, slot_us=112.0, soft_step=True, soft_temp=0.3,
            loss_rate=0.01, loss_burst_len=4.0, jitter_us=20.0,
            flap_period_us=1000.0, flap_depth=0.3)
STEPS = 303
# the steps read: the first 140 (values), and for the VJP the first slot
# boundary (22 steps a slot), the first arrivals past the one-way delay (96
# steps), the sixth boundary, the first step past a round trip (192 steps:
# what the destination sent back, CNPs and acknowledgements, reaches the
# source), the destination OTN's queue at its PFC threshold (near step 229)
# and that pause back at the source a one-way delay later; values at each
# VJP step too
VJP_TS = (21, 97, 131, 197, 229, 301)
VALUE_TS = sorted({*range(0, 140, 9), *VJP_TS})


@pytest.mark.parametrize("channel", [None, "impaired"])
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_soft_step_and_vjp_match_jax(scheme, channel):
    jcfgs, pcfgs = [JNetConfig(**BASE)], [NetConfig(**BASE)]
    wl = jwork.throughput_workload(8e6, 4, num_flows=4)
    states, outs = jax_states(jcfgs, wl, scheme, STEPS, channel)
    step = port_step(pcfgs, pwork.throughput_workload(8e6, 4, num_flows=4),
                     scheme, channel)
    worst = worst_step_errors(states, outs, step, VALUE_TS)
    assert not over_step_limits(worst), over_step_limits(worst)
    vjp = step_vjp_errors(jcfgs, pcfgs, wl, scheme, states, outs, VJP_TS, channel)
    bad = {k: v for k, v in vjp.items() if v[0] > STEP_REL}
    assert len(vjp) > 60 and not bad, bad
