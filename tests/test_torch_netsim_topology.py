"""The port's multi-link engine (``num_paths > 1``) against the JAX package:
the ideal-channel cases of ``tests/test_topology.py`` on the port, and the
seven schemes' ``full`` traces on one delay-spread cell of
``benchmarks/scheme_compare.py``'s topology grid (``torch_parity.LINKS3``:
100 km, delays x1 / x2 / x4, capacities 0.6 / 0.3 / 0.1; the golden
congestion workload, 10 ms) against a live JAX run, held as
``tests/test_torch_netsim_sim.py`` holds the golden ones (traces within
``TRACE_REL`` until a recorded parting, the Fig. 3 columns, the final
state), the per-link keys included. Queue levels are read against at least
``QUEUE_SCALE`` bytes.
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
from repro_torch.netsim.workload import FlowSpec, Workload
from torch_parity import (
    ALL_SCHEMES, COLUMN_FLOORS, GOLDEN, LINKS3_H_US, PARTS, QUEUE_SCALE,
    assert_columns_close, assert_final_close, assert_traces_close_before,
    fig3_columns, golden_workload, leaves, links3_config,
)

H_US = 3_000.0
WL = pwork.throughput_workload(msg_size=1 << 20, concurrency=16, num_flows=4)
LINK_KEYS = ("q_dst_link", "link_tx", "link_pause")
FLOORS = {k: QUEUE_SCALE for k in ("q_src", "q_dst", "q_leaf", "q_dst_link")}


def _cfg3(**kw):
    """Three unequal paths, the longer ones thinner (test_topology._cfg3)."""
    base = dict(distance_km=100.0, num_paths=3, path_delay_scale=(1.0, 1.5, 2.0),
                path_cap_frac=(0.5, 0.3, 0.2))
    base.update(kw)
    return NetConfig(**base)


def _run(cfgs, wl, scheme, h=H_US, **kw):
    return pfl.simulate_batch(cfgs, wl, scheme, h, device="cpu", **kw)


# ------------------------------------------------------------------ L = 1


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_explicit_unit_path_tuples_equal_one_link(scheme):
    """num_paths=1 with the path tuples spelled out is the bare config bit
    for bit, with no per-link trace keys."""
    spelled = NetConfig(distance_km=100.0, num_paths=1, path_delay_scale=(1.0,),
                        path_cap_frac=(1.0,))
    a = leaves(_run([NetConfig(distance_km=100.0)], WL, scheme, 1_000.0))
    b = leaves(_run([spelled], WL, scheme, 1_000.0))
    assert sorted(a) == sorted(b)
    assert not any(k.split(".")[-1] in LINK_KEYS for k in a)
    assert not [k for k in a if not np.array_equal(a[k], b[k])]


# ------------------------------------------------------------------ L > 1


def test_multilink_shapes_conserve_and_trace():
    final, tr = _run([_cfg3(), _cfg3(distance_km=300.0)], WL, "dcqcn")
    steps = int(H_US / 5.0)
    assert final.q_dst.shape == (2, 3, 4) and final.pipe.shape[-2:] == (3, 4)
    assert final.pause_line.shape[-1] == 3 and final.pause_dst.shape == (2, 3)
    for k in LINK_KEYS:
        assert tr[k].shape == (2, steps, 3), k
    assert float(tr["cons_err"].max()) < 1e-3
    assert float(final.delivered.sum()) > 0


def test_route_matrix_steers_traffic():
    """A workload routed onto links 0 and 1 leaves link 2 dark."""
    wl = Workload(tuple(FlowSpec(True, 1 << 20, 16, route=(1.0, 1.0, 0.0))
                        for _ in range(4)))
    _, tr = _run([_cfg3()], wl, "dcqcn")
    assert float(tr["link_tx"][0, :, 2].max()) == 0.0
    assert float(tr["link_tx"][0, :, :2].sum()) > 0.0


def test_route_width_mismatch_raises_as_jax():
    def wl(work):
        return work.Workload(tuple(work.FlowSpec(True, 1 << 20, 16, route=(1.0, 1.0))
                                   for _ in range(2)))
    jcfg = JNetConfig(distance_km=100.0, num_paths=3)
    with pytest.raises(ValueError, match="route") as jerr:
        jnetsim.simulate_batch([jcfg], wl(jwork), jnetsim.get_scheme("dcqcn"), 100.0)
    with pytest.raises(ValueError, match="2 link columns but cfg.num_paths = 3") as perr:
        _run([NetConfig(distance_km=100.0, num_paths=3)], wl(pwork), "dcqcn", 100.0)
    assert str(jerr.value).split(" — ")[0] == str(perr.value).split(" - ")[0]


def test_multilink_batch_matches_sequential():
    cfgs = [_cfg3(), _cfg3(path_delay_scale=(1.0, 1.2, 1.4))]
    finals, tr = _run(cfgs, WL, "dcqcn")
    for i, cfg in enumerate(cfgs):
        f, t1 = _run([cfg], WL, "dcqcn")
        # the batch pads the rings to its longest delay: sums in another order
        np.testing.assert_allclose(tr["thr_inter"][i].numpy(), t1["thr_inter"][0].numpy(),
                                   rtol=1e-4, atol=1e4)
        np.testing.assert_allclose(finals.delivered[i].numpy(), f.delivered[0].numpy(),
                                   rtol=1e-5)


def test_rdmacell_sprays_toward_capacity():
    """Token buckets refill at link rate, so the steady spray (the last ms of
    8 ms, as test_topology reads it) tracks capacity (0.5 / 0.3 / 0.2) where
    the workload-routed baseline sprays evenly."""
    _, cell = _run([_cfg3()], WL, "rdmacell", 8_000.0)
    _, base = _run([_cfg3()], WL, "dcqcn", 8_000.0)
    tail = {k: t["link_tx"][0, -200:].numpy().mean(0)
            for k, t in (("cell", cell), ("base", base))}
    np.testing.assert_allclose(tail["cell"] / tail["cell"].sum(), (0.5, 0.3, 0.2),
                               atol=0.05)
    np.testing.assert_allclose(tail["base"] / tail["base"].sum(), (1 / 3,) * 3,
                               atol=0.05)
    assert float(cell["rdmacell_tokens_mb"].min()) >= 0.0
    assert float(cell["rdmacell_rob_mb"].min()) >= 0.0


def test_rdmacell_rob_limit_gates_senders():
    """A tight ROB limit holds the estimated reorder buffer at or below what
    a loose one allows, and throttles the inter-DC senders."""
    runs = {lim: _run([_cfg3(rdmacell_rob_limit_mb=lim)], WL, "rdmacell")[1]
            for lim in (1e4, 0.5)}
    rob = {lim: float(t["rdmacell_rob_mb"][0, -200:].mean()) for lim, t in runs.items()}
    assert rob[0.5] <= rob[1e4] + 1e-6
    assert float(runs[0.5]["thr_inter"].mean()) <= float(runs[1e4]["thr_inter"].mean())


def test_rdmacell_streamed_columns():
    """rdmacell's spraying columns on L = 3, the baseline's on L = 1."""
    (row,) = prunner.run_experiment_batch([_cfg3()], WL, "rdmacell", H_US,
                                          trace_mode="metrics", device="cpu")
    assert row["mean_reorder_buf_mb"] >= 0.0 and 0.5 < row["spray_entropy"] < 1.0
    (row1,) = prunner.run_experiment_batch([NetConfig(distance_km=100.0)], WL,
                                           "rdmacell", H_US, trace_mode="metrics",
                                           device="cpu")
    assert "spray_entropy" not in row1 and "mean_budget_gbps" in row1


def test_chunk_cells_counts_link_keys_as_jax():
    for steps, mode, k, n in ((44_000, "full", 1, 3), (4_000, "decimate", 10, 4),
                              (44_000, "metrics", 1, 3), (44_000, "full", 1, 1)):
        assert prunner.chunk_cells(steps, mode, k, num_links=n) == \
            jnetsim.runner.chunk_cells(steps, mode, k, num_links=n)


def test_route_and_site_leaves_match_jax():
    """WorkloadParams's route leaf (padded to the widest route) and site
    leaves are the JAX package's."""
    def wls(work):
        return [work.Workload((work.FlowSpec(True, 1 << 20, 4, route=(1.0, 0.0, 2.0)),
                               work.FlowSpec(True, 1 << 20, 4, src_site=2, dst_site=1),
                               work.FlowSpec(False, 1 << 10, 2, dst_site=1))),
                work.Workload((work.FlowSpec(True, 1 << 10, 1, route=(0.5,)),))]
    j = jwork.stack_workload_params(wls(jwork))
    p = pwork.stack_workload_params(wls(pwork))
    assert p.route.shape == (2, 3, 3)
    for k, v in leaves(j).items():
        assert np.array_equal(leaves(p)[k], v), k


# ------------------------------------------------ the seven schemes vs JAX


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_links3_traces_match_jax(scheme):
    jf, jt = jnetsim.simulate_batch([links3_config(JNetConfig)],
                                    golden_workload("seq", jwork),
                                    jnetsim.get_scheme(scheme), LINKS3_H_US)
    pf, pt = _run([links3_config(NetConfig)], golden_workload("seq", pwork), scheme,
                  LINKS3_H_US)
    jt = {k: np.asarray(v) for k, v in jt.items()}
    pt = {k: v.numpy() for k, v in pt.items()}
    steps = jt["q_dst"].shape[1]
    assert sorted(pt) == sorted(jt) and pt["link_tx"].shape == (1, steps, 3)
    part, _ = PARTS.get(("links3", scheme), (steps, None))
    what = f"links3/{scheme}"
    assert_traces_close_before(pt, jt, part, what, floors=FLOORS)
    assert_columns_close(fig3_columns(pt, steps), fig3_columns(jt, steps), what,
                         COLUMN_FLOORS)
    assert_final_close(pf, jf, 5.0, what)
    assert GOLDEN["seq"][3] == LINKS3_H_US
