"""``simulate``/``simulate_batch`` of the port in ``metrics`` and ``decimate``
modes against a live JAX run, for the paper's four schemes on the golden
scenarios (``tests/test_torch_netsim_sim.py`` has ``full`` mode; the
tolerances and recorded partings are in ``tests/torch_parity.py``).

``metrics``: the streamed Fig. 3 reductions (warm-step means of the queues,
pause and throughput; running maxes; the histogram's p99) within
``COLUMN_REL`` / ``PAUSE_ABS`` over the whole horizon, the p99 within one
histogram bin; the schemes' streamed sums within ``COLUMN_REL``; final
states as in full mode. ``decimate`` (every 10th step, on the batch): the
kept rows within ``TRACE_REL`` before the parting step and the Fig. 3
columns of the decimated traces.
"""
import jax
import numpy as np
import pytest

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import workload as pwork
from repro_torch.netsim.fluid import acc_columns
from repro_torch.netsim.streaming import HIST_BINS, hist_quantile
from torch_parity import (
    COLUMN_REL, GOLDEN, PARTS, SCHEMES, assert_columns_close,
    assert_final_close, assert_traces_close_before, fig3_columns,
    golden_configs, golden_workload, leaves,
)

DECIMATE = 10
# one bin of the log histogram: 12 decades over HIST_BINS - 1 bins
BIN_RATIO = 10 ** (12 / (HIST_BINS - 1))


def _runs(name, scheme, **kw):
    jcfgs, pcfgs = golden_configs(name, JNetConfig), golden_configs(name, NetConfig)
    h = GOLDEN[name][3]
    jf, ja = jnetsim.simulate_batch(jcfgs, golden_workload(name, jwork),
                                    jnetsim.get_scheme(scheme), h, **kw)
    pf, pa = pfl.simulate_batch(pcfgs, golden_workload(name, pwork), scheme, h,
                                device="cpu", **kw)
    return jf, jax.tree.map(np.asarray, ja), pf, pa


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_streamed_metrics_match_jax(name, scheme):
    jf, ja, pf, pa = _runs(name, scheme, trace_mode="metrics")
    steps = int(GOLDEN[name][3] / 5.0)
    n_warm = steps - int(steps * pfl.WARMUP_FRAC)
    cols = acc_columns(pa)
    means = {k: cols["sum_s"][k].numpy() / n_warm for k in ("thr_inter", "q_dst")}
    ref = {k: ja.sum_s[k] / n_warm for k in ("thr_inter", "q_dst")}
    assert_columns_close(
        {"throughput": means["thr_inter"], "mean_buffer": means["q_dst"],
         "peak_buffer": cols["maxes"]["q_dst"].numpy(),
         "pause_ratio": cols["sum_s"]["pause_dst"].numpy() / n_warm},
        {"throughput": ref["thr_inter"], "mean_buffer": ref["q_dst"],
         "peak_buffer": ja.maxes["q_dst"],
         "pause_ratio": ja.sum_s["pause_dst"] / n_warm}, f"{name}/{scheme}")
    p99_p = hist_quantile(pa.hist.numpy(), 0.99)
    p99_j = hist_quantile(ja.hist, 0.99)
    assert np.all((p99_p <= p99_j * BIN_RATIO * 1.0001)
                  & (p99_j <= p99_p * BIN_RATIO * 1.0001)), (p99_p, p99_j)
    assert int(pa.hist.sum()) == int(ja.hist.sum()) == n_warm * len(golden_configs(name, NetConfig))
    for k, r in leaves(ja.scheme).items():
        p = leaves(pa.scheme)[k]
        assert np.abs(p - r).max() <= COLUMN_REL * np.abs(r).max(), (k, p, r)
    assert sorted(leaves(pa.scheme)) == sorted(leaves(ja.scheme))
    assert_final_close(pf, jf, 5.0, f"{name}/{scheme}")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decimated_traces_match_jax(scheme):
    name = "batch"
    jf, jt, pf, pt = _runs(name, scheme, trace_mode="decimate", decimate=DECIMATE)
    pt = {k: v.numpy() for k, v in pt.items()}
    rows = jt["q_dst"].shape[1]
    assert rows == int(GOLDEN[name][3] / 5.0) // DECIMATE
    part = PARTS.get((name, scheme), (rows * DECIMATE, None))[0]
    assert_traces_close_before(pt, jt, part, f"decimate {scheme}", DECIMATE)
    assert_columns_close(fig3_columns(pt, rows), fig3_columns(jt, rows), scheme)
    assert_final_close(pf, jf, 5.0, f"decimate {scheme}")
