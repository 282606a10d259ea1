"""The port's channel subsystem (``repro_torch.netsim.channel`` and the
engine's loss-repair path) against the JAX package on the golden congestion
cell under the ``impaired`` channel (loss, jitter and flap at once;
``torch_parity.IMPAIRED_KNOBS``, 3 ms), for all seven schemes:

  * the free run's traces within ``TRACE_REL`` (2e-4) until the runs part at
    a recorded threshold (``PARTS``), the Fig. 3 columns over the horizon
    within 1e-3, the final state within 1e-4;

The single steps and the rows are held in
``tests/test_torch_netsim_channel_steps.py``.
"""
import numpy as np
import pytest

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import workload as pwork
from torch_parity import (
    ALL_SCHEMES, IMPAIRED_H_US, IMPAIRED_KNOBS, PARTS, QUEUE_SCALE, SEQ_KW,
    assert_columns_close, assert_final_close,
    assert_traces_close_before, fig3_columns,
)

FLOORS = {k: QUEUE_SCALE for k in ("q_src", "q_dst", "q_leaf")}
CHAN_KEYS = {"chan_wire", "chan_lost", "chan_retx", "chan_backlog",
             "chan_repair_wait_us"}


def _cells(netconfig):
    return [netconfig(**IMPAIRED_KNOBS)]


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_impaired_golden_traces_match_jax(scheme):
    jf, jt = jnetsim.simulate_batch(_cells(JNetConfig), jwork.congestion_workload(**SEQ_KW),
                                    jnetsim.get_scheme(scheme), IMPAIRED_H_US,
                                    channel="impaired")
    pf, pt = pfl.simulate_batch(_cells(NetConfig), pwork.congestion_workload(**SEQ_KW),
                                scheme, IMPAIRED_H_US, channel="impaired", device="cpu")
    jt = {k: np.asarray(v) for k, v in jt.items()}
    pt = {k: v.numpy() for k, v in pt.items()}
    assert sorted(pt) == sorted(jt) and CHAN_KEYS <= set(pt)
    assert jt["chan_lost"].sum() > 0 and jt["chan_retx"].sum() > 0
    steps = jt["q_dst"].shape[1]
    part, _ = PARTS.get(("impaired", scheme), (steps, None))
    what = f"impaired/{scheme}"
    assert_traces_close_before(pt, jt, part, what, floors=FLOORS)
    assert_columns_close(fig3_columns(pt, steps), fig3_columns(jt, steps), what)
    assert_final_close(pf, jf, 5.0, what)
    # the same draws: the steps that drop more than a byte coincide until
    # the parting (a drop of a drained queue's residue reads ~1e-3 B)
    before = slice(0, part)
    np.testing.assert_array_equal(jt["chan_lost"][:, before] > 1.0,
                                  pt["chan_lost"][:, before] > 1.0)
