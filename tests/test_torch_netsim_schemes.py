"""The related-work schemes of the port (``geopipe``, ``sdr_rdma``,
``rdmacell``) against a live JAX run on the golden scenarios of
``tests/golden/generate_goldens.py`` (the congestion cell at 100 km, 10 ms;
the throughput batch at 1 and 300 km, 8 ms): teacher-forced single steps
within 1e-6 of each leaf's largest value (``torch_netsim_jax``), ``full``
traces within ``TRACE_REL`` until a recorded parting (``PARTS``), the
Fig. 3 columns and final state as ``tests/test_torch_netsim_sim.py`` holds
them, the streamed rows with the schemes' own columns within 1e-3
(``assert_rows_close``); and rdmacell on one link, bit for bit the port's
dcqcn. Queue levels are read against at least ``QUEUE_SCALE`` bytes.
"""
import numpy as np
import pytest

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from torch_netsim_jax import (
    jax_states, over_step_limits, port_step, worst_step_errors,
)
from torch_parity import (
    COLUMN_FLOORS, GOLDEN, PARTS, QUEUE_SCALE, RELATED, assert_columns_close,
    assert_final_close, assert_rows_close, assert_traces_close_before,
    fig3_columns, golden_configs, golden_workload, leaves,
)

FLOORS = {k: QUEUE_SCALE for k in ("q_src", "q_dst", "q_leaf")}


def _sampled(steps):
    """Every 9th step, every other MatchRDMA slot boundary and every geopipe
    stage boundary ((t + 1) dt a multiple of 200 us, and the step after)."""
    ts = (set(range(0, steps, 9)) | set(range(19, steps, 80))
          | set(range(39, steps, 40)) | set(range(40, steps, 40)))
    return sorted(t for t in ts if t < steps - 1)


@pytest.mark.parametrize("scheme", RELATED)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_single_step_matches_jax(name, scheme):
    steps = int(GOLDEN[name][3] / 5.0)
    states, outs = jax_states(golden_configs(name, JNetConfig),
                              golden_workload(name, jwork), scheme, steps)
    step = port_step(golden_configs(name, NetConfig),
                     golden_workload(name, pwork), scheme)
    worst = worst_step_errors(states, outs, step, _sampled(steps))
    assert len(worst) > 38, sorted(worst)
    bad = over_step_limits(worst)
    assert not bad, f"leaves over the limit (error, step): {bad}"


@pytest.mark.parametrize("scheme", RELATED)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_full_traces_match_jax(name, scheme):
    h = GOLDEN[name][3]
    jf, jt = jnetsim.simulate_batch(golden_configs(name, JNetConfig),
                                    golden_workload(name, jwork),
                                    jnetsim.get_scheme(scheme), h)
    pf, pt = pfl.simulate_batch(golden_configs(name, NetConfig),
                                golden_workload(name, pwork), scheme, h,
                                device="cpu")
    jt = {k: np.asarray(v) for k, v in jt.items()}
    pt = {k: v.numpy() for k, v in pt.items()}
    steps = jt["q_dst"].shape[1]
    assert sorted(pt) == sorted(jt)
    part, _ = PARTS.get((name, scheme), (steps, None))
    what = f"{name}/{scheme}"
    assert_traces_close_before(pt, jt, part, what, floors=FLOORS)
    assert_columns_close(fig3_columns(pt, steps), fig3_columns(jt, steps), what,
                         COLUMN_FLOORS)
    assert_final_close(pf, jf, 5.0, what)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_streamed_rows_match_jax(name):
    h = GOLDEN[name][3]
    jrows = jnetsim.sweep_grid(golden_configs(name, JNetConfig),
                               golden_workload(name, jwork), RELATED, h,
                               trace_mode="metrics")
    prows = prunner.sweep_grid(golden_configs(name, NetConfig),
                               golden_workload(name, pwork), RELATED, h,
                               trace_mode="metrics", device="cpu")
    assert_rows_close(prows, jrows, True, f"{name} metrics")
    own = {"geopipe": ("mean_credit_mb", "credit_stall_frac"),
           "sdr_rdma": ("mean_ack_lag_mb", "mean_retx_reserve_frac"),
           "rdmacell": ("mean_budget_gbps",)}
    for r in prows:
        assert all(c in r for c in own[r["scheme"]]), r


@pytest.mark.parametrize("mode", ["full", "metrics"])
def test_rdmacell_is_dcqcn_on_one_link(mode):
    """On one link rdmacell carries the default extra state and the baseline
    hooks: its run is the port's dcqcn bit for bit."""
    cfgs = golden_configs("seq", NetConfig)
    wl = golden_workload("seq", pwork)
    runs = [pfl.simulate_batch(cfgs, wl, s, 4_000.0, trace_mode=mode,
                               device="cpu") for s in ("dcqcn", "rdmacell")]
    (df, da), (rf, ra) = runs
    if mode == "metrics":
        # dcqcn also streams its mean sender rate: compare the shared sums
        da = da._replace(scheme=da.scheme["budget_sum"])
        ra = ra._replace(scheme=ra.scheme["budget_sum"])
    d, r = leaves((df, da)), leaves((rf, ra))
    assert sorted(d) == sorted(r) and len(d) > 40
    diff = [k for k in d if not np.array_equal(d[k], r[k])]
    assert not diff, diff
