"""The port's failure schedules and hardened runner, mirroring
``tests/test_failures.py`` (the JAX package's):

  * ``FailureSchedule`` building, padding and validation, and its JSON, with
    the JAX package's messages (and each package reading the other's file);
  * an all-up schedule bit-equal to no schedule, at L = 1 and L = 3;
  * outages against a live JAX run (three unequal links at 100 km under a
    streaming workload): a link-0 outage for all seven schemes and a site
    outage (every link down) for five, traces within ``TRACE_REL`` before a
    recorded parting (rdmacell's reorder-buffer trace against
    ``ROB_SCALE_MB``), the Fig. 3 and channel columns, the final state; the
    dump into the repair path with conservation, and the re-spray onto the
    survivors (no byte on a dead link);
  * every link down: a stall, nothing non-finite;
  * every scheme's ``route_weights`` under any live mask equal to JAX's,
    finite, non-negative and zero on dead links;
  * the runner's hardening: ``ConservationError`` coordinates, the
    non-finite guard, a resumed sweep bit-equal to an uninterrupted one, a
    fingerprint mismatch refused, a torn checkpoint re-run, and the OOM
    backoff through a patched launch.
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import fluid as jfl
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import (
    FailureSchedule, load_failure_json, save_failure_json,
)
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from torch_parity import (
    ALL_SCHEMES, COLUMN_FLOORS, PARTS, QUEUE_SCALE, ROB_SCALE_MB,
    assert_columns_close,
    assert_final_close, assert_rows_close, assert_traces_close_before,
    fig3_columns, leaves,
)

ALL_UP_1 = (((0.0, 0.0),),)
MULTI = dict(distance_km=100.0, num_paths=3, path_cap_frac=(0.5, 0.3, 0.2))
H_US = 3_000.0
FLOORS = {k: QUEUE_SCALE for k in ("q_src", "q_dst", "q_leaf", "q_dst_link")}
FLOORS["rdmacell_rob_mb"] = ROB_SCALE_MB


def _swl(work):
    """Streaming traffic that keeps the pipe full, so an outage always
    catches bytes in flight."""
    return work.throughput_workload(msg_size=1 << 23, concurrency=4, num_flows=4)


def _outage(netconfig, fs_cls, kind="link0"):
    fs = fs_cls.empty(3)
    if kind == "link0":
        fs = fs.link_outage(0, 600.0, 2_000.0)
    elif kind == "site":
        fs = fs.site_outage(1, 600.0, 1_500.0, ((0, 1),) * 3)
    else:
        for li in range(3):
            fs = fs.link_outage(li, 600.0, 1_500.0)
    return fs.apply(netconfig(**MULTI))


def _raised(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


def _run(cfgs, wl, scheme, h=H_US, **kw):
    return pfl.simulate_batch(cfgs, wl, scheme, h, device="cpu", **kw)


# ---------------------------------------------------------------------------
# The schedule builder and its JSON
# ---------------------------------------------------------------------------

def test_schedule_builder_composes_pads_and_compiles_as_jax():
    def build(fs_cls, netconfig):
        fs = (fs_cls.empty(3).link_outage(0, 1_000.0, 2_000.0)
              .link_outage(0, 5_000.0, 6_000.0).link_outage(2, 3_000.0, 4_000.0))
        return fs, fs.apply(netconfig(**MULTI))
    pfs, pcfg = build(FailureSchedule, NetConfig)
    jfs, jcfg = build(jnetsim.FailureSchedule, JNetConfig)
    assert pfs.num_windows == 2 and pfs.to_config_tuple() == jfs.to_config_tuple()
    assert pfs.to_config_tuple()[1] == ((0.0, 0.0), (0.0, 0.0))
    assert pcfg.failure_len == jcfg.failure_len == 2
    assert np.array_equal(pcfg.failure_array(), jcfg.failure_array())
    pairs = ((0, 1), (0, 2), (2, 1))
    site = FailureSchedule.empty(3).site_outage(2, 1_000.0, 2_000.0, pairs)
    assert site.windows == ((), ((1_000.0, 2_000.0),), ((1_000.0, 2_000.0),))
    assert FailureSchedule.empty(4).to_config_tuple() == ()
    assert FailureSchedule.empty(3).apply(NetConfig(**MULTI)).failure_len == 0


@pytest.mark.parametrize("bad", [
    lambda m: m.FailureSchedule.empty(2).link_outage(0, 5_000.0, 5_000.0),
    lambda m: m.FailureSchedule.empty(2).link_outage(0, -1.0, 5.0),
    lambda m: m.FailureSchedule.empty(2).link_outage(2, 0.0, 5.0),
    lambda m: m.FailureSchedule.empty(2).site_outage(7, 1.0, 2.0, ((0, 1), (0, 1))),
    lambda m: m.FailureSchedule(0),
    lambda m: m.FailureSchedule(2, ((),)),
])
def test_schedule_validation_raises_as_jax(bad):
    from repro_torch import netsim as pnetsim
    assert _raised(lambda: bad(pnetsim)) == _raised(lambda: bad(jnetsim))


def test_apply_checks_link_count_as_jax():
    j = _raised(lambda: jnetsim.FailureSchedule.empty(2).link_outage(0, 1.0, 2.0)
                .apply(JNetConfig(**MULTI)))
    p = _raised(lambda: FailureSchedule.empty(2).link_outage(0, 1.0, 2.0)
                .apply(NetConfig(**MULTI)))
    assert j == p and "num_paths is 3" in p[1]


def test_failure_json_roundtrip_across_packages(tmp_path):
    fs = FailureSchedule.empty(2).link_outage(0, 1_000.0, 2_000.0).link_outage(1, 3_000.0, 4_500.0)
    save_failure_json(tmp_path / "p.json", fs)
    assert load_failure_json(tmp_path / "p.json") == fs
    assert jnetsim.load_failure_json(tmp_path / "p.json").windows == fs.windows
    jnetsim.save_failure_json(tmp_path / "j.json", jnetsim.load_failure_json(tmp_path / "p.json"))
    assert (tmp_path / "j.json").read_text() == (tmp_path / "p.json").read_text()


def test_failure_json_errors_name_the_edge(tmp_path):
    p = tmp_path / "bad.json"
    for doc in ({"edges": [{"windows": [[0.0, 5.0]]}, {"windows": [[1.0]]}]},
                {"edges": [{"windows": [[5.0, 2.0]]}]}, {"edges": []}):
        p.write_text(json.dumps(doc))
        assert _raised(lambda: load_failure_json(p)) == _raised(
            lambda: jnetsim.load_failure_json(p))


# ---------------------------------------------------------------------------
# All-up identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_all_up_bit_equal_to_no_schedule(scheme):
    wl = pwork.throughput_workload(msg_size=1 << 20, concurrency=1, num_flows=4)
    base = [NetConfig(distance_km=d) for d in (1.0, 100.0)]
    up = [dataclasses.replace(c, failure_schedule=ALL_UP_1) for c in base]
    a, b = leaves(_run(base, wl, scheme, 1_000.0)), leaves(_run(up, wl, scheme, 1_000.0))
    assert set(a) <= set(b) and not [k for k in a if not np.array_equal(a[k], b[k])]
    assert np.all(b["1.fail_live"] == 1.0) and b["1.fail_live"].shape == (2, 200)


def test_all_up_multilink_bit_equal_to_no_schedule():
    cfg = NetConfig(**MULTI)
    up = FailureSchedule(3, (((0.0, 0.0),),) * 3).apply(cfg)
    a = leaves(_run([cfg], _swl(pwork), "rdmacell", 1_500.0))
    b = leaves(_run([up], _swl(pwork), "rdmacell", 1_500.0))
    assert set(a) <= set(b) and not [k for k in a if not np.array_equal(a[k], b[k])]
    assert b["1.fail_live"].shape == (1, 300, 3)


# ---------------------------------------------------------------------------
# Outages against JAX
# ---------------------------------------------------------------------------

def _outage_runs(scheme, kind, h=H_US):
    jf, jt = jnetsim.simulate_batch([_outage(JNetConfig, jnetsim.FailureSchedule, kind)],
                                    _swl(jwork), jnetsim.get_scheme(scheme), h)
    pf, pt = _run([_outage(NetConfig, FailureSchedule, kind)], _swl(pwork), scheme, h)
    return (jf, {k: np.asarray(v) for k, v in jt.items()},
            pf, {k: v.numpy() for k, v in pt.items()})


def _against_jax(scheme, kind, name):
    jf, jt, pf, pt = _outage_runs(scheme, kind)
    steps = jt["q_dst"].shape[1]
    assert sorted(pt) == sorted(jt) and {"fail_live", "chan_lost"} <= set(pt)
    part, _ = PARTS.get((name, scheme), (steps, None))
    what = f"{name}/{scheme}"
    assert_traces_close_before(pt, jt, part, what, floors=FLOORS)
    assert_columns_close(fig3_columns(pt, steps), fig3_columns(jt, steps), what,
                         COLUMN_FLOORS)
    assert_final_close(pf, jf, 5.0, what)
    return pt


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_link_outage_matches_jax(scheme):
    """A dead link's in-flight bytes are dumped, ride the notification ring
    home and are re-sent over the survivors, as in JAX; conservation holds
    and nothing launches onto the dead link."""
    pt = _against_jax(scheme, "link0", "link_outage")
    if scheme != "geopipe":
        # geopipe's credit gate holds this cell's traffic at the source
        # through the outage (in JAX too): nothing in flight to dump
        assert pt["chan_lost"].sum() > 0 and pt["chan_retx"].sum() > 0
    assert pt["cons_err"].max() < 1e-3
    live, tx = pt["fail_live"][0], pt["link_tx"][0]            # [T, L]
    assert np.all(live[:, 1:] == 1.0) and np.all(live[125:395, 0] == 0.0)
    assert np.all(live[:115, 0] == 1.0) and np.all(live[405:, 0] == 1.0)
    assert tx[125:395, 0].sum() == 0.0 and tx[125:395, 1:].sum(0).min() > 0.0
    assert tx[:115, 0].sum() > 0.0


@pytest.mark.parametrize("scheme", ("dcqcn", "matchrdma", "sdr_rdma", "rdmacell"))
def test_site_outage_matches_jax(scheme):
    pt = _against_jax(scheme, "site", "site_outage")
    assert pt["link_tx"][0, 125:295].sum() == 0.0
    assert pt["cons_err"].max() < 1e-3


def test_site_outage_geopipe_parts_at_the_source_pfc():
    """geopipe's site-outage run parts where the source OTN fills to its PFC
    threshold while every link is down (``PARTS``): the traces agree before
    that step, and sum(q_src) lies on either side of xoff_otn in the two
    runs just before it."""
    part, _ = PARTS[("site_outage", "geopipe")]
    _, jt, _, pt = _outage_runs("geopipe", "site")
    assert_traces_close_before(pt, jt, part, "site_outage/geopipe", floors=FLOORS)
    xoff_otn = 0.1 * (NetConfig().otn_capacity_gbps * 1e9 / 8.0) * 2.0 \
        * NetConfig(**MULTI).one_way_delay_us * 1e-6
    a, b = jt["q_src"][0, part - 1], pt["q_src"][0, part - 1]
    assert (a > xoff_otn) != (b > xoff_otn), (a, b, xoff_otn)
    assert pt["link_tx"][0, 125:295].sum() == 0.0


def test_site_outage_rdmacell_parts_at_the_source_pfc():
    """rdmacell's site-outage run parts where the source OTN fills to its PFC
    threshold after the outage (``PARTS``, step 606, past this file's 3 ms):
    run on to 3.1 ms, the traces agree before that step (the reorder-buffer
    trace read against ROB_SCALE_MB), and sum(q_src) lies on either side of
    xoff_otn in the two runs just before it."""
    part, _ = PARTS[("site_outage", "rdmacell")]
    _, jt, _, pt = _outage_runs("rdmacell", "site", h=3_100.0)
    assert jt["q_src"].shape[1] > part
    assert_traces_close_before(pt, jt, part, "site_outage/rdmacell", floors=FLOORS)
    xoff_otn = 0.1 * (NetConfig().otn_capacity_gbps * 1e9 / 8.0) * 2.0 \
        * NetConfig(**MULTI).one_way_delay_us * 1e-6
    a, b = jt["q_src"][0, part - 1], pt["q_src"][0, part - 1]
    assert (a > xoff_otn) != (b > xoff_otn), (a, b, xoff_otn)
    # the residue the ROB scale reads through: 2e-6 MB in JAX, 0 in the port
    assert jt["rdmacell_rob_mb"][0, 401] > 0.0
    assert pt["rdmacell_rob_mb"][0, 401] == 0.0


def test_all_links_down_stalls_without_nans():
    final, tr = _run([_outage(NetConfig, FailureSchedule, "all")], _swl(pwork), "matchrdma")
    for k, v in tr.items():
        assert torch.isfinite(v).all(), k
    thr = tr["thr_inter"][0].numpy()
    assert thr[150:280].sum() == 0.0 and thr[:110].sum() > 0.0
    assert torch.isfinite(final.sent).all() and float(tr["cons_err"].max()) < 1e-3


def test_failure_rows_match_jax():
    """Rows of an outage grid (an all-up control, link 0, the site) with the
    channel and failover columns, decimated as the failover grid runs."""
    def cfgs(netconfig, fs_cls):
        up = fs_cls(3, (((0.0, 0.0),),) * 3).apply(netconfig(**MULTI))
        return [up] + [_outage(netconfig, fs_cls, k) for k in ("link0", "site")]
    j = jnetsim.sweep_grid(cfgs(JNetConfig, jnetsim.FailureSchedule), _swl(jwork),
                           ("dcqcn", "sdr_rdma"), H_US, trace_mode="decimate", decimate=4)
    p = prunner.sweep_grid(cfgs(NetConfig, FailureSchedule), _swl(pwork),
                           ("dcqcn", "sdr_rdma"), H_US, trace_mode="decimate", decimate=4,
                           device="cpu")
    assert {"failover_collapse_frac", "failover_recovery_us", "retx_frac"} <= set(p[0])
    assert p[0]["failover_collapse_frac"] == 0.0 and p[0]["failover_recovery_us"] == 0.0
    assert_rows_close(p, j, what="failure rows")


# ---------------------------------------------------------------------------
# route_weights under any live mask, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_route_weights_live_mask_property(scheme):
    jcfg, pcfg = JNetConfig(**MULTI), NetConfig(**MULTI)
    jwl = _swl(jwork).params()
    jstep = jfl.make_step_fn(jcfg, jwl, jnetsim.get_scheme(scheme))
    jstate = jfl.init_state(jcfg, 4, scheme=jnetsim.get_scheme(scheme))
    _, pstate, pstep = pfl.build_batch([pcfg], _swl(pwork), scheme, device="cpu")
    psch = pfl.get_scheme(scheme)
    import jax.numpy as jnp
    for live_bits in range(8):
        live = np.array([(live_bits >> i) & 1 for i in range(3)], np.float32)
        for route_bits in range(1, 8):
            for scale in (0.01, 1.0, 100.0):
                row = np.array([(route_bits >> i) & 1 for i in range(3)], np.float32) * scale
                base = np.tile(row, (4, 1))
                jw = np.asarray(jnetsim.get_scheme(scheme).route_weights(
                    jstep.ctx._replace(link_live=jnp.asarray(live)), jstate,
                    jnp.asarray(base)))
                pw = psch.route_weights(
                    pstep.ctx._replace(link_live=torch.as_tensor(live)[None]), pstate,
                    torch.as_tensor(base)[None])[0].numpy()
                assert np.isfinite(pw).all() and (pw >= 0.0).all()
                assert np.all(pw[:, live == 0.0] == 0.0)
                np.testing.assert_allclose(pw, jw, rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------------------
# The hardened runner
# ---------------------------------------------------------------------------

def test_strict_conservation_reports_coordinates():
    cfg = _outage(NetConfig, FailureSchedule)
    with pytest.raises(prunner.ConservationError) as ei:
        prunner.run_experiment_batch([cfg], _swl(pwork), "dcqcn", 1_500.0,
                                     trace_mode="decimate", decimate=4,
                                     strict_conservation=True, conservation_tol=1e-12,
                                     device="cpu")
    err = ei.value
    assert (err.scheme_name, err.cell) == ("dcqcn", 0)
    assert err.step is not None and (err.step + 1) % 4 == 0 and err.err > 1e-12
    with pytest.raises(prunner.ConservationError, match="step unknown"):
        prunner.run_experiment_batch([cfg], _swl(pwork), "dcqcn", 1_500.0,
                                     trace_mode="metrics", strict_conservation=True,
                                     conservation_tol=1e-12, device="cpu")
    rows = prunner.run_experiment_batch([cfg], _swl(pwork), "dcqcn", 1_500.0,
                                        trace_mode="decimate", decimate=4,
                                        strict_conservation=True, device="cpu")
    assert len(rows) == 1


def test_conservation_coordinate_math_as_jax():
    cons = np.zeros((3, 5), np.float32)
    cons[1, 2], cons[2, 0] = 7e-3, 9e-3                  # row 2 is padding
    for mod in (prunner, jnetsim.runner):
        with pytest.raises(mod.ConservationError) as ei:
            mod._check_conservation("dcqcn", {"cons_err": cons}, lo=10, n_real=2,
                                    trace_mode="decimate", decimate=4, tol=1e-3)
        assert (ei.value.cell, ei.value.step) == (11, 11)
        mod._check_conservation("dcqcn", {"cons_err": cons}, lo=10, n_real=1,
                                trace_mode="decimate", decimate=4, tol=1e-3)
    macc = SimpleNamespace(maxes=torch.tensor([[0, 0, 0, 0.0], [0, 0, 0, 5e-3],
                                               [0, 0, 0, 9e-3]]))
    with pytest.raises(prunner.ConservationError) as ei:
        prunner._check_conservation("themis", macc, lo=4, n_real=2,
                                    trace_mode="metrics", decimate=1, tol=1e-3)
    assert (ei.value.cell, ei.value.step) == (5, None)


def test_nonfinite_guard_as_jax():
    good = {"scheme": "dcqcn", "distance_km": 10.0, "throughput_gbps": 1.0,
            "avg_fct_us": float("inf")}
    bad = {"scheme": "dcqcn", "distance_km": 20.0, "throughput_gbps": float("nan"),
           "peak_buffer_mb": float("inf")}
    for mode in ("keep", "quarantine"):
        assert prunner._guard_nonfinite([good, bad], 4, mode) == \
            jnetsim.runner._guard_nonfinite([good, bad], 4, mode)
    assert prunner._guard_nonfinite([good, bad], 4, "quarantine")[1]["cell_index"] == 5
    with pytest.raises(RuntimeError, match="cell 5 .*peak_buffer_mb"):
        prunner._guard_nonfinite([good, bad], 4, "raise")
    with pytest.raises(ValueError, match="on_nonfinite"):
        prunner.run_experiment_batch([NetConfig(**MULTI)], _swl(pwork), "dcqcn", 100.0,
                                     trace_mode="metrics", on_nonfinite="explode",
                                     device="cpu")


def test_checkpoint_resume_is_bit_identical(tmp_path):
    cfgs = [FailureSchedule.empty(3).link_outage(0, 300.0, 600.0 + 100.0 * i)
            .apply(NetConfig(**MULTI)) for i in range(3)]
    kw = dict(trace_mode="metrics", chunk_cells=1, device="cpu")
    ref = prunner.sweep_grid(cfgs, _swl(pwork), ("dcqcn", "matchrdma"), 1_000.0, **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="abort_after_launches"):
        prunner.sweep_grid(cfgs, _swl(pwork), ("dcqcn", "matchrdma"), 1_000.0,
                           checkpoint_dir=ck, abort_after_launches=3, **kw)
    assert len(os.listdir(ck)) == 3
    resumed = prunner.sweep_grid(cfgs, _swl(pwork), ("dcqcn", "matchrdma"), 1_000.0,
                                 checkpoint_dir=ck, resume=True, **kw)
    assert len(resumed) == len(ref) == 6
    for a, b in zip(ref, resumed):
        assert set(a) == set(b)
        for k, v in a.items():
            assert v == b[k] or (isinstance(v, float) and np.isnan(v) and np.isnan(b[k])), k


def test_checkpoint_fingerprint_mismatch_refuses(tmp_path):
    ck = str(tmp_path / "ck")
    kw = dict(trace_mode="metrics", checkpoint_dir=ck, device="cpu")
    prunner.sweep_grid([NetConfig(**MULTI)], _swl(pwork), ("dcqcn",), 500.0, **kw)
    with pytest.raises(ValueError, match="DIFFERENT launch plan"):
        prunner.sweep_grid([NetConfig(**MULTI)], _swl(pwork), ("dcqcn",), 600.0,
                           resume=True, **kw)
    path = os.path.join(ck, os.listdir(ck)[0])
    with open(path, "w") as f:
        f.write('{"fingerprint": "abc", "rows": [{"thro')
    rows = prunner.sweep_grid([NetConfig(**MULTI)], _swl(pwork), ("dcqcn",), 500.0,
                              resume=True, **kw)
    assert len(rows) == 1 and "throughput_gbps" in rows[0]


def test_oom_backoff_splits_launches(monkeypatch):
    real, calls = prunner.simulate_batch, []

    def fake(cfgs, *a, **kw):
        calls.append(len(cfgs))
        if len(cfgs) > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 EiB")
        return real(cfgs, *a, **kw)

    monkeypatch.setattr(prunner, "simulate_batch", fake)
    cfgs = [dataclasses.replace(NetConfig(**MULTI), distance_km=d) for d in (10.0, 50.0, 100.0)]
    with pytest.warns(RuntimeWarning, match="device OOM"):
        rows = prunner.run_experiment_batch(cfgs, _swl(pwork), "dcqcn", 500.0,
                                            trace_mode="metrics", device="cpu")
    assert [r["distance_km"] for r in rows] == [10.0, 50.0, 100.0]
    assert max(calls) > 1 and calls.count(1) == 3


def test_oom_backoff_gives_up_at_single_cell(monkeypatch):
    def always_oom(cfgs, *a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(prunner, "simulate_batch", always_oom)
    with pytest.warns(RuntimeWarning, match="device OOM"), \
            pytest.raises(torch.cuda.OutOfMemoryError):
        prunner.run_experiment_batch([NetConfig(**MULTI)] * 2, _swl(pwork), "dcqcn",
                                     500.0, trace_mode="metrics", device="cpu")


def test_schedule_tables_shrink_the_chunk_as_jax():
    """The auto chunk counts a cell's resident schedule tables (failure
    windows, replay schedule) as the JAX runner does."""
    cfg = FailureSchedule.empty(3).link_outage(0, 1.0, 2.0).link_outage(0, 3.0, 4.0) \
        .apply(NetConfig(**MULTI))
    floats = prunner._sched_floats(cfg)
    assert floats == jnetsim.runner._sched_floats(_jax_cfg(cfg)) == 12
    for steps, mode, k, sf in ((44_000, "full", 1, floats), (4_000, "decimate", 4, 3 * 8 * 3),
                               (4_000, "metrics", 1, 10 ** 7)):
        assert prunner.chunk_cells(steps, mode, k, schedule_floats=sf) == \
            jnetsim.runner.chunk_cells(steps, mode, k, schedule_floats=sf)


def test_window_count_mismatch_raises_as_jax():
    """W is static: cells with different window counts do not batch."""
    def pair(netconfig, fs_cls):
        one = fs_cls.empty(3).link_outage(0, 1.0, 2.0)
        return [one.apply(netconfig(**MULTI)),
                one.link_outage(0, 3.0, 4.0).apply(netconfig(**MULTI))]
    j = _raised(lambda: jnetsim.simulate_batch(
        pair(JNetConfig, jnetsim.FailureSchedule), _swl(jwork),
        jnetsim.get_scheme("dcqcn"), 100.0))
    p = _raised(lambda: _run(pair(NetConfig, FailureSchedule), _swl(pwork), "dcqcn", 100.0))
    assert j[0] is p[0] is ValueError
    assert "failure_schedule window counts differ" in j[1]
    assert "failure_schedule window counts differ" in p[1]


def _jax_cfg(cfg):
    return JNetConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
