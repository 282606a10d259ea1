"""The port's runner against the JAX package's: ``run_experiment_batch`` and
``sweep_grid`` rows (``full`` and ``metrics`` modes, heterogeneous scenario
grids, chunked plans), malformed options, which raise, and the options
that run (channels, hardening knobs, failure schedules, ``window``
mode, run manifests, the soft step in every trace mode), and the entry
point's device rule.

Row tolerances (the Fig. 3 columns): throughput, goodput, peak / mean / p99
buffer and intra-DC throughput within ``COLUMN_REL`` (1e-3) relative plus
``ABS_FLOOR``; pause ratio within ``PAUSE_ABS`` (1e-3); in ``metrics`` mode
the p99 within one histogram bin; average FCT within one step (``dt_us``,
FCTs are step times); completion equal; the schemes' streamed columns within
1e-3 (``torch_parity.assert_rows_close``).
"""
import warnings

import numpy as np
import pytest
import torch

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from torch_parity import assert_rows_close

H_US = 4_000.0

def _grid(netconfig, work):
    """Mixed distances and capacities, three workloads (a padded flow set)."""
    cells = [(1.0, 16, "throughput_workload", dict(msg_size=1 << 20, concurrency=2, num_flows=4)),
             (100.0, 16, "congestion_workload", dict(num_inter=3, num_intra=2,
                                                     burst_start_us=1_000.0,
                                                     burst_len_us=1_500.0,
                                                     horizon_us=H_US)),
             (300.0, 8, "mixed_fct_workload", dict(msg_size=16 << 10, num_inter=2,
                                                   num_intra=2, num_background=1,
                                                   request_start_us=500.0)),
             (50.0, 4, "throughput_workload", dict(msg_size=64 << 10, concurrency=4, num_flows=2))]
    return ([netconfig(distance_km=d, num_otn_links=n) for d, n, _, _ in cells],
            [getattr(work, b)(**kw) for _, _, b, kw in cells])


@pytest.mark.parametrize("mode", ["full", "metrics"])
def test_sweep_grid_rows_match_jax(mode):
    jcfgs, jwls = _grid(JNetConfig, jwork)
    pcfgs, pwls = _grid(NetConfig, pwork)
    schemes = ("dcqcn", "pseudo_ack", "themis", "matchrdma")
    jrows = jnetsim.sweep_grid([jnetsim.Scenario(c, w) for c, w in zip(jcfgs, jwls)],
                               schemes, horizon_us=H_US, trace_mode=mode)
    # full mode with chunk_cells=3: two launches, the second padded with its
    # last cell
    prows = prunner.sweep_grid([prunner.Scenario(c, w) for c, w in zip(pcfgs, pwls)],
                               schemes, horizon_us=H_US, trace_mode=mode,
                               chunk_cells=3 if mode == "full" else None,
                               device="cpu")
    assert_rows_close(prows, jrows, mode == "metrics", f"sweep_grid {mode}")


def test_run_experiment_batch_and_sweep_match_jax():
    wl_j = jwork.throughput_workload(256 << 10, 2, 3)
    wl_p = pwork.throughput_workload(256 << 10, 2, 3)
    dists = (1.0, 200.0)
    jrows = jnetsim.run_experiment_batch([JNetConfig(distance_km=d) for d in dists],
                                         wl_j, jnetsim.get_scheme("matchrdma"), H_US)
    prows = prunner.run_experiment_batch([NetConfig(distance_km=d) for d in dists],
                                         wl_p, "matchrdma", H_US, device="cpu")
    assert_rows_close(prows, jrows, what="run_experiment_batch")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j1 = jnetsim.run_experiment(JNetConfig(distance_km=10.0), wl_j, "themis", H_US)
    p1 = prunner.run_experiment(NetConfig(distance_km=10.0), wl_p, "themis", H_US,
                                device="cpu")
    assert_rows_close([p1], [j1], what="run_experiment")
    js = jnetsim.sweep(JNetConfig(), wl_j, ("dcqcn",), (1.0, 20.0), horizon_us=H_US)
    ps = prunner.sweep(NetConfig(), wl_p, ("dcqcn",), (1.0, 20.0), horizon_us=H_US,
                       device="cpu")
    assert_rows_close(ps, js, what="sweep")
    cfgs = [NetConfig(distance_km=d) for d in (10.0, 700.0)]
    assert prunner.convergence_horizon_us(cfgs) == jnetsim.runner.convergence_horizon_us(
        [JNetConfig(distance_km=d) for d in (10.0, 700.0)])


def test_chunk_plan_matches_jax():
    for steps, mode, k in ((44_000, "full", 1), (20_000, "decimate", 10),
                           (44_000, "metrics", 1)):
        assert prunner.chunk_cells(steps, mode, k) == \
            jnetsim.runner.chunk_cells(steps, mode, k)
    assert prunner._plan_launches(10, ("a",), 4) == [
        prunner._Launch("a", lo, hi, 4) for lo, hi in ((0, 4), (4, 8), (8, 10))]


@pytest.mark.parametrize("cfg,kw,item", [
    (dict(), dict(devices=[]), "empty device list"),
    (dict(), dict(devices=["cpu"], on_nonfinite="drop"), "on_nonfinite"),
])
def test_unported_runner_options_raise(cfg, kw, item):
    """Every runner option is ported (``devices=`` since the parallel
    slice: tests/test_torch_train_mesh.py); a malformed one raises."""
    with pytest.raises(ValueError, match=item):
        prunner.run_experiment_batch([NetConfig(**cfg)], pwork.throughput_workload(1 << 20, 1, 2),
                                     "dcqcn", 100.0, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(channel="bernoulli_loss"), dict(checkpoint_dir="ck"),
    dict(strict_conservation=True), dict(on_nonfinite="raise"),
    dict(abort_after_launches=1), dict(trace_mode="window"),
    dict(manifest_path="m.jsonl"),
])
def test_ported_runner_options_run(kw, tmp_path):
    """The channel, the hardening knobs, window mode and run manifests
    (ROADMAP queue 1 items 13 and 15) run; tests/test_torch_netsim_{channel,
    failures,obs,manifest}.py hold what they do."""
    if "checkpoint_dir" in kw:
        kw = dict(checkpoint_dir=str(tmp_path / "ck"))
    if "manifest_path" in kw:
        kw = dict(manifest_path=str(tmp_path / "m.jsonl"))
    rows = prunner.run_experiment_batch([NetConfig()], pwork.throughput_workload(1 << 20, 1, 2),
                                        "dcqcn", 100.0, device="cpu", **kw)
    assert len(rows) == 1 and np.isfinite(rows[0]["throughput_gbps"])
    assert ("retx_frac" in rows[0]) == ("channel" in kw)


@pytest.mark.parametrize("cfg,kw", [
    (dict(num_paths=2, soft_step=True), dict(channel="jitter")),
    (dict(soft_step=True), dict()),
    (dict(soft_step=True), dict(trace_mode="window")),
    (dict(soft_step=True), dict(trace_mode="decimate", decimate=4)),
    (dict(soft_step=True), dict(trace_mode="metrics")),
])
def test_soft_configs_run(cfg, kw):
    """The soft step (ROADMAP queue 1 item 16) runs in every trace mode, on
    one link and on two; tests/test_torch_netsim_soft_convergence.py holds
    its rows against JAX's."""
    rows = prunner.run_experiment_batch([NetConfig(**cfg)],
                                        pwork.throughput_workload(1 << 20, 1, 2),
                                        "matchrdma", 200.0, device="cpu", **kw)
    assert len(rows) == 1 and np.isfinite(rows[0]["throughput_gbps"])


@pytest.mark.parametrize("cfg", [
    dict(num_sites=3, num_paths=3, site_edges=((0, 1), (0, 2), (2, 1)),
         failure_schedule=(((5.0, 20.0),),) * 3),
    dict(failure_schedule=(((5.0, 20.0),),)),
])
def test_failure_configs_run(cfg):
    """Failure schedules (ROADMAP queue 1 item 15) run: the live mask is a
    trace key, down for the window (5 <= t_us < 20: steps 1-3)."""
    from repro_torch.netsim.fluid import simulate_batch
    _, tr = simulate_batch([NetConfig(**cfg)], pwork.throughput_workload(1 << 20, 1, 2),
                           "dcqcn", 100.0, device="cpu")
    live = tr["fail_live"].numpy()
    assert live.shape[:2] == (1, 20) and live[0, 1:4].max() == 0.0
    assert live[0, 0].min() == 1.0 and live[0, 4:].min() == 1.0


def test_entry_point_runs_on_cuda_unless_asked():
    from repro_torch.launch import netsim as launch
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--figure", "fig3cd", "--horizon-us", "50"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prunner.run_experiment_batch([NetConfig()], pwork.throughput_workload(1 << 20, 1, 2),
                                     "dcqcn", 100.0)
    out = launch.main(["--figure", "fig3cd", "--horizon-us", "50", "--device", "cpu"])
    assert out["device"] == "cpu" and len(out["rows"]) == 10
    assert [r["scheme"] for r in out["schemes"]] == ["dcqcn", "pseudo_ack", "themis",
                                                     "matchrdma"]
