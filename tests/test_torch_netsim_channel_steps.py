"""The port's channel step against the JAX package's, one step at a time: on
the golden congestion cell under the ``impaired`` channel
(``torch_parity.IMPAIRED_KNOBS``), JAX's state before a step (the channel
slots, the notification ring and the retransmit backlog included) is loaded
into the port, stepped once, and the new state and the step's traces are held
within 1e-6 of each leaf's largest value over the run
(``torch_netsim_jax.STEP_REL``; ``cons_err`` 1e-6 absolute), for all seven
schemes, at steps spread over the run and on both sides of each recorded
parting. The draws are the same numbers, so the Gilbert–Elliott drops, the
jitter holds and the flap dips fall on the same steps. Then the rows of
``run_experiment_batch`` on that cell at 100 and 300 km, channel columns
included (``assert_rows_close``).
"""
import pytest

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from torch_netsim_jax import jax_states, over_step_limits, port_step, worst_step_errors
from torch_parity import (
    ALL_SCHEMES, IMPAIRED_H_US, IMPAIRED_KNOBS, PARTS, SEQ_KW, assert_rows_close,
)


def _cells(netconfig):
    return [netconfig(**IMPAIRED_KNOBS)]


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_impaired_single_steps_match_jax(scheme):
    """Teacher-forced single steps on both sides of every parting."""
    wl_j, wl_p = (w.congestion_workload(**SEQ_KW) for w in (jwork, pwork))
    steps = int(IMPAIRED_H_US / 5.0)
    states, outs = jax_states(_cells(JNetConfig), wl_j, scheme, steps,
                              channel="impaired")
    step = port_step(_cells(NetConfig), wl_p, scheme, channel="impaired")
    part, _ = PARTS.get(("impaired", scheme), (steps - 1, None))
    ts = sorted(set(range(0, steps - 1, 37)) | {max(part - 1, 0), min(part, steps - 2)})
    worst = worst_step_errors(states, outs, step, ts)
    assert "chan.bad" in worst and "retx_line" in worst
    assert not over_step_limits(worst), over_step_limits(worst)


@pytest.mark.parametrize("scheme,mode", [("pseudo_ack", "full"),
                                         ("matchrdma", "metrics")])
def test_impaired_rows_match_jax(scheme, mode):
    """Rows with the channel columns (pseudo_ack and matchrdma do not part on
    this cell): the Fig. 3 and channel columns within 1e-3, the streamed p99
    repair latency within one histogram bin."""
    cells = [dict(IMPAIRED_KNOBS, distance_km=d) for d in (100.0, 300.0)]
    jrows = jnetsim.run_experiment_batch(
        [JNetConfig(**c) for c in cells], jwork.congestion_workload(**SEQ_KW),
        jnetsim.get_scheme(scheme), IMPAIRED_H_US, trace_mode=mode, channel="impaired")
    prows = prunner.run_experiment_batch(
        [NetConfig(**c) for c in cells], pwork.congestion_workload(**SEQ_KW),
        scheme, IMPAIRED_H_US, trace_mode=mode, channel="impaired", device="cpu")
    assert {"goodput_gbps", "wire_gbps", "retx_frac", "p99_repair_latency_us"} <= set(prows[0])
    assert_rows_close(prows, jrows, mode == "metrics", f"impaired rows {scheme} {mode}")
