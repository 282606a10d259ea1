"""The channel and failure figures of ``python -m repro_torch.launch.netsim``
(``--figure impairment``, ``sites`` and ``failover``) against
``benchmarks/scheme_compare.py``'s ``run_impairment_grid``,
``run_sites_grid`` and ``run_failover_grid``: the same cells, configs,
schedules, workloads and asserted columns; each grid's rows against the JAX
package's ``sweep_grid`` at a cut horizon (``assert_rows_close``, the channel
and failover columns included) for the schemes that do not part on it (dcqcn,
themis and rdmacell part where the source OTN meets its PFC threshold, 250 KB
of goodput, as on scheme_compare's 50 km cell: ``PARTS``); the sdr_rdma vs
dcqcn repair-latency reading of the JAX smoke cell, equal in both packages;
and the failover figure end to end with checkpoints and a resume.
"""
import json

import numpy as np
import pytest

import repro.netsim as jnetsim
from benchmarks import scheme_compare as sc
from repro.config.base import NetConfig as JNetConfig
from repro_torch.launch import netsim as launch
from repro_torch.netsim import WorkloadParams
from repro_torch.netsim import runner as prunner
from torch_parity import assert_rows_close

CUT_US = 3_000.0
ROW_SCHEMES = ("pseudo_ack", "matchrdma", "sdr_rdma")


def _jax_cfg(cfg):
    """The JAX package's NetConfig with the same fields."""
    return JNetConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_grid_definitions_are_scheme_compare_s():
    assert launch.CHANNEL_COLS == sc.CHANNEL_COLS
    assert launch.FAILOVER_COLS == sc.FAILOVER_COLS
    assert [(e.src, e.dst, e.delay_scale, e.cap_frac) for e in launch.SITES_EDGES] == \
        [(e.src, e.dst, e.delay_scale, e.cap_frac) for e in sc.SITES_EDGES]
    for scale in (0.0, 0.25, 0.5, 1.0):
        assert launch.sites_schedule(scale) == sc._sites_schedule(scale)
    for h in (6_000.0, 20_000.0):
        a = WorkloadParams.of(launch.sites_workload(h))
        b = sc._sites_workload(h).params()
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))
        a, b = WorkloadParams.of(launch.compare_workload(h)), sc._workload(h).params()
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))
    cells, cfgs = launch.impairment_cells(full=True)
    assert len(cells) == 15 and len(launch.impairment_cells()[0]) == 6
    assert {(c.loss_rate, c.jitter_us, c.loss_burst_len, c.distance_km) for c in cfgs} == \
        {(lr, j, 4.0, 50.0) for lr, j in cells}
    assert len(launch.sites_cells(20_000.0)[0]) == 9
    assert len(launch.sites_cells(20_000.0, full=True)[0]) == 20
    assert len(launch.failover_cells(20_000.0)[0]) == 6
    assert len(launch.failover_cells(20_000.0, full=True)[0]) == 9


def _jax_failover_cfgs(h):
    """run_failover_grid's configs, built with the JAX package's builder."""
    t_down, fs = h / 3.0, jnetsim.FailureSchedule
    base = JNetConfig(distance_km=100.0, num_paths=3, path_cap_frac=(0.5, 0.3, 0.2))
    out = []
    for kind in ("none", "link0", "site"):
        for dur in (h / 10.0, h / 5.0):
            s = (fs(3).link_outage(0, t_down, t_down + dur) if kind == "link0" else
                 fs(3).site_outage(1, t_down, t_down + dur, ((0, 1),) * 3)
                 if kind == "site" else fs(3, (((0.0, 0.0),),) * 3))
            out.append(s.apply(base))
    return out


def test_failover_and_sites_configs_equal_jax_s():
    _, cfgs = launch.failover_cells(20_000.0)
    assert [_jax_cfg(c) for c in cfgs] == _jax_failover_cfgs(20_000.0)
    _, cfgs = launch.sites_cells(20_000.0)
    jax_sites = [_jax_cfg(c) for c in cfgs]
    assert [c.channel_schedule for c in jax_sites] == \
        [sc._sites_schedule(s) for _ in (1.0, 1.5, 2.5) for s in (0.0, 0.5, 1.0)]
    assert all(c.channel_schedule_dt_us == 2_500.0 and c.num_paths == 4 for c in jax_sites)


@pytest.mark.parametrize("grid", ["impairment", "sites", "failover"])
def test_grid_rows_match_jax(grid):
    if grid == "impairment":
        _, cfgs = launch.impairment_cells()
        wl, jwl = launch.compare_workload(CUT_US), sc._workload(CUT_US)
        kw = dict(trace_mode="metrics", channel="impaired")
    elif grid == "sites":
        _, cfgs = launch.sites_cells(CUT_US)
        wl, jwl = launch.sites_workload(CUT_US), sc._sites_workload(CUT_US)
        kw = dict(trace_mode="metrics", channel="trace_replay")
    else:
        _, cfgs = launch.failover_cells(CUT_US)
        wl, jwl = launch.compare_workload(CUT_US), sc._workload(CUT_US)
        kw = dict(trace_mode="decimate", decimate=4, strict_conservation=True)
    jrows = jnetsim.sweep_grid([_jax_cfg(c) for c in cfgs], jwl, ROW_SCHEMES, CUT_US, **kw)
    prows = prunner.sweep_grid(cfgs, wl, ROW_SCHEMES, CUT_US, device="cpu", **kw)
    cols = launch.FAILOVER_COLS if grid == "failover" else launch.CHANNEL_COLS
    assert all(c in r for r in prows for c in cols)
    assert_rows_close(prows, jrows, kw["trace_mode"] == "metrics", grid)


def test_smoke_cell_repair_latency_equals_jax():
    """scheme_compare's impairment smoke cell (loss 0.02, no jitter, 50 km,
    6 ms): sdr_rdma's streamed p99 repair latency is above dcqcn's there in
    both packages (ROADMAP queue 3: the JAX smoke trips its own assert), the
    same histogram bin in each."""
    cfg = launch.impairment_cells()[1][4]
    assert (cfg.loss_rate, cfg.jitter_us) == (0.02, 0.0)
    h = 6_000.0
    for scheme in ("dcqcn", "sdr_rdma"):
        j = jnetsim.run_experiment_batch([_jax_cfg(cfg)], sc._workload(h),
                                         jnetsim.get_scheme(scheme), h,
                                         trace_mode="metrics", channel="impaired")[0]
        p = prunner.run_experiment_batch([cfg], launch.compare_workload(h), scheme, h,
                                         trace_mode="metrics", channel="impaired",
                                         device="cpu")[0]
        assert p["p99_repair_latency_us"] == j["p99_repair_latency_us"], scheme
        if scheme == "dcqcn":
            dcqcn = p["p99_repair_latency_us"]
    assert p["p99_repair_latency_us"] > dcqcn > 0


def test_failover_figure_checkpoints_and_resumes(tmp_path):
    """The failover figure end to end on the CPU at 6 ms, its asserts
    included, with a checkpoint per launch; a resumed run loads every launch
    and prints the same rows."""
    argv = ["--figure", "failover", "--device", "cpu", "--horizon-us", "6000",
            "--checkpoint-dir", str(tmp_path / "ck")]
    first = launch.main(argv)
    assert len(list((tmp_path / "ck").iterdir())) == 7
    again = launch.main(argv + ["--resume"])
    assert all(r.get("resumed") for r in again["schemes"])
    assert json.dumps(again["rows"][-7:]) == json.dumps(first["rows"][-7:])
    assert [r[2] for r in again["rows"]] == [r[2] for r in first["rows"]]
    with pytest.raises(SystemExit):
        launch.main(["--figure", "sites", "--checkpoint-dir", str(tmp_path)])
