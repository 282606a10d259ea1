"""``simulate``/``simulate_batch`` of the port against a live JAX run, for the
paper's four schemes on the golden scenarios (the congestion cell at 100 km,
10 ms, through ``simulate``; the throughput batch at 1 and 300 km, 8 ms,
through ``simulate_batch``), ``full`` traces (``metrics`` and ``decimate``
modes are in ``tests/test_torch_netsim_sim_modes.py``).

Tolerances and the recorded partings are in ``tests/torch_parity.py``: traces
agree within ``TRACE_REL`` of each key's largest value until the step where
the runs part (``PARTS``: a hard threshold that ulp-level differences flip),
the Fig. 3 columns over the whole horizon within ``COLUMN_REL`` /
``PAUSE_ABS``, final ``sent``/``delivered`` within ``FINAL_REL`` and
completion times within one step. Never against ``tests/golden/*.npz``: the
goldens do not reproduce under the installed JAX.
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
    GOLDEN, PARTS, SCHEMES, assert_columns_close, assert_final_close,
    assert_traces_close_before, fig3_columns, golden_configs, golden_workload,
)

XOFF_OTN_100KM = 2e7      # 0.1 x 2D x C_otn at 100 km, bytes


def _jax(name, scheme, **kw):
    cfgs = golden_configs(name, JNetConfig)
    wl = golden_workload(name, jwork)
    sch = jnetsim.get_scheme(scheme)
    if name == "seq":
        final, aux = jnetsim.simulate(cfgs[0], wl, sch, GOLDEN[name][3], **kw)
        return final, {k: np.asarray(v)[None] for k, v in aux.items()}
    final, aux = jnetsim.simulate_batch(cfgs, wl, sch, GOLDEN[name][3], **kw)
    return final, {k: np.asarray(v) for k, v in aux.items()}


def _port(name, scheme, **kw):
    cfgs = golden_configs(name, NetConfig)
    wl = golden_workload(name, pwork)
    if name == "seq":
        final, aux = pfl.simulate(cfgs[0], wl, scheme, GOLDEN[name][3],
                                  device="cpu", **kw)
        return final, {k: v.numpy()[None] for k, v in aux.items()}
    final, aux = pfl.simulate_batch(cfgs, wl, scheme, GOLDEN[name][3],
                                    device="cpu", **kw)
    return final, {k: v.numpy() for k, v in aux.items()}


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_full_traces_match_jax(name, scheme):
    jf, jt = _jax(name, scheme)
    pf, pt = _port(name, scheme)
    steps = jt["q_dst"].shape[1]
    assert sorted(pt) == sorted(jt) and pt["q_dst"].shape == jt["q_dst"].shape
    part, why = PARTS.get((name, scheme), (steps, None))
    what = f"{name}/{scheme}"
    assert_traces_close_before(pt, jt, part, what)
    assert_columns_close(fig3_columns(pt, steps), fig3_columns(jt, steps), what)
    assert_final_close(pf, jf, 5.0, what)
    if why and "sum(q_src)" in why:
        # the recorded threshold: the step before the part leaves the two
        # runs on opposite sides of xoff_otn
        a, b = jt["q_src"][0, part - 1], pt["q_src"][0, part - 1]
        assert (a > XOFF_OTN_100KM) != (b > XOFF_OTN_100KM), (a, b)
