"""The port's ``trace_replay`` channel, mirroring ``tests/test_trace_replay.py``
(the JAX package's): the schedule bites where and when it is recorded (slot
timing against JAX's at slot boundaries that an f32 reciprocal would move),
per-edge independence on the 3-site mesh of ``benchmarks/scheme_compare.py``
and its traces against a live JAX run under the sites grid's schedule,
all-neutral slots bit-equal to no schedule, the channel columns across
trace modes, the schedule as a per-scenario leaf, and the JSON helpers and
shape errors (the same messages as JAX).
"""
import dataclasses

import numpy as np
import pytest

import repro.netsim as jnetsim
from benchmarks import scheme_compare as sc
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import channel as jchannel
from repro.netsim import topology as jtopo
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig, stack_net_params
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import topology as ptopo
from repro_torch.netsim import workload as pwork
from repro_torch.netsim.channel import (
    load_schedule_json, save_schedule_json, schedule_from_arrays,
)
from torch_parity import (
    COLUMN_FLOORS, MESH_H_US, PARTS, QUEUE_SCALE, assert_columns_close,
    assert_final_close, assert_traces_close_before, fig3_columns, leaves,
    mesh_config, mesh_workload,
)

WL = pwork.throughput_workload(msg_size=1 << 20, concurrency=16, num_flows=4)
HORIZON = 2_000.0
K = 8
SLOT_US = HORIZON / K
FLOORS = {k: QUEUE_SCALE for k in ("q_src", "q_dst", "q_leaf", "q_dst_link")}


def _timeline(loss=(), defer=(), cap=()):
    lo, de, ca = np.zeros(K, np.float32), np.zeros(K, np.float32), np.ones(K, np.float32)
    for arr, pairs in ((lo, loss), (de, defer), (ca, cap)):
        for i, v in pairs:
            arr[i] = v
    return schedule_from_arrays(lo, de, ca)


def _cfg(timeline, netconfig=NetConfig, **kw):
    return netconfig(distance_km=10.0, channel_schedule=(timeline,),
                     channel_schedule_dt_us=SLOT_US, **kw)


def _msg(err) -> str:
    """An error's message with the JAX package's em dashes as hyphens."""
    return str(err).replace("\u2014", "-")


def _run(cfgs, wl, scheme="dcqcn", h=HORIZON, **kw):
    return pfl.simulate_batch(cfgs, wl, scheme, h, channel="trace_replay",
                              device="cpu", **kw)


def test_replay_reproduces_loss_window():
    """Loss recorded only in slot 2 drops bytes only inside its window."""
    cfg = _cfg(_timeline(loss=[(2, 0.25)]))
    _, tr = _run([cfg], WL)
    lost = tr["chan_lost"][0].numpy()
    n = int(round(SLOT_US / cfg.dt_us))
    assert lost[2 * n:3 * n].sum() > 0.0
    assert lost[:2 * n].sum() == 0.0 and lost[3 * n:].sum() == 0.0
    assert float(tr["cons_err"].max()) < 1e-3


@pytest.mark.parametrize("entry_us", [55.0, 115.0, 1_000.0])
def test_slot_boundaries_land_on_jax_steps(entry_us):
    """The slot is floor(t * dt / entry) with a true division: at entry 55 or
    115 us an f32 reciprocal puts hundreds of boundaries a step late. The
    steps that lose bytes are JAX's."""
    loss = np.zeros(K, np.float32)
    loss[1::2] = 0.5
    tl = schedule_from_arrays(loss)
    kw = dict(distance_km=1.0, channel_schedule=(tl,), channel_schedule_dt_us=entry_us)
    wl_j = jwork.throughput_workload(msg_size=1 << 20, concurrency=16, num_flows=4)
    _, jt = jnetsim.simulate_batch([JNetConfig(**kw)], wl_j, jnetsim.get_scheme("dcqcn"),
                                   HORIZON, channel="trace_replay")
    _, pt = _run([NetConfig(**kw)], WL)
    np.testing.assert_array_equal(np.asarray(jt["chan_lost"]) > 0,
                                  pt["chan_lost"].numpy() > 0)


def test_replay_cap_dip_throttles_wire():
    wl = pwork.throughput_workload(4 << 20, 8, num_flows=4)
    _, tr_dip = _run([_cfg(_timeline(cap=[(3, 0.4), (4, 0.4)]), num_otn_links=4)], wl)
    _, tr_clean = _run([_cfg(_timeline(), num_otn_links=4)], wl)
    n = int(round(SLOT_US / 5.0))
    sl = slice(3 * n, 5 * n)
    wire_dip = float(tr_dip["chan_wire"][0, sl].sum())
    wire_clean = float(tr_clean["chan_wire"][0, sl].sum())
    assert wire_dip < 0.7 * wire_clean, (wire_dip, wire_clean)


def test_replay_defer_conserves():
    """Recorded deferral holds bytes back (counted in the conservation
    residual) and releases them all once the slots clear."""
    cfg = _cfg(_timeline(defer=[(i, 0.5) for i in range(2, 6)]))
    final, tr = _run([cfg], WL)
    assert float(tr["cons_err"].max()) < 1e-4
    assert float(final.chan.defer.sum()) == 0.0


def test_per_edge_schedules_are_independent_on_the_mesh():
    """On the 3-site mesh each edge replays its own row: loss recorded on the
    two 0->1 edges hits flows 0->1 and spares the relay's."""
    lossy = _timeline(loss=[(i, 0.2) for i in range(K)])
    base = dataclasses.replace(mesh_config(NetConfig, ptopo),
                               channel_schedule=(lossy, lossy, _timeline(), _timeline()),
                               channel_schedule_dt_us=SLOT_US)

    def wl(*pairs):
        return pwork.Workload(tuple(pwork.FlowSpec(True, 1 << 20, 16, src_site=s, dst_site=d)
                                    for s, d in pairs))

    _, tr = _run([base, base], [wl((0, 1), (0, 1)), wl((0, 2), (2, 1))])
    lost = tr["chan_lost"].numpy().sum(-1)
    assert lost[0] > 0.0 and lost[1] == 0.0


SITES_SCHEMES = ("dcqcn", "matchrdma", "rdmacell")


@pytest.mark.parametrize("scheme", SITES_SCHEMES)
def test_sites_replay_traces_match_jax(scheme):
    """The sites grid's cell at scale 1, relay spread 1.5, against JAX: traces
    before a recorded parting, the Fig. 3 columns, the final state."""
    def cfg(netconfig, topo, sched):
        g = topo.SiteGraph(3, (topo.SiteEdge(0, 1), topo.SiteEdge(0, 1, delay_scale=1.5),
                               topo.SiteEdge(0, 2, cap_frac=0.2, delay_scale=1.5),
                               topo.SiteEdge(2, 1, cap_frac=0.2, delay_scale=1.5)))
        return dataclasses.replace(
            g.to_net_config(netconfig(distance_km=100.0,
                                      channel_schedule_dt_us=MESH_H_US / 8.0)),
            channel_schedule=sched)
    sched = sc._sites_schedule(1.0)
    jf, jt = jnetsim.simulate_batch([cfg(JNetConfig, jtopo, sched)], mesh_workload(jwork),
                                    jnetsim.get_scheme(scheme), MESH_H_US,
                                    channel="trace_replay")
    pf, pt = _run([cfg(NetConfig, ptopo, sched)], mesh_workload(pwork), scheme, MESH_H_US)
    jt = {k: np.asarray(v) for k, v in jt.items()}
    pt = {k: v.numpy() for k, v in pt.items()}
    steps = jt["q_dst"].shape[1]
    assert sorted(pt) == sorted(jt) and pt["chan_lost"].sum() > 0
    part, _ = PARTS.get(("sites", scheme), (steps, None))
    what = f"sites/{scheme}"
    assert_traces_close_before(pt, jt, part, what, floors=FLOORS)
    assert_columns_close(fig3_columns(pt, steps), fig3_columns(jt, steps), what,
                         COLUMN_FLOORS)
    assert_final_close(pf, jf, 5.0, what)


def test_neutral_slots_bit_identical_to_no_schedule():
    _, tr_n = _run([_cfg(_timeline())], WL, "matchrdma")
    _, tr_e = _run([NetConfig(distance_km=10.0)], WL, "matchrdma")
    assert sorted(tr_n) == sorted(tr_e)
    for k in tr_n:
        assert np.array_equal(tr_n[k].numpy(), tr_e[k].numpy()), k


def test_channel_columns_cross_mode_parity():
    tl = _timeline(loss=[(2, 0.1), (5, 0.05)], defer=[(3, 0.3)], cap=[(6, 0.6)])
    cwl = pwork.congestion_workload(num_inter=4, num_intra=4, burst_start_us=500.0,
                                    burst_len_us=800.0, horizon_us=HORIZON)
    cfgs = [NetConfig(distance_km=d, channel_schedule=(tl,), channel_schedule_dt_us=SLOT_US)
            for d in (10.0, 50.0)]
    rows = {m: prunner.run_experiment_batch(cfgs, cwl, "sdr_rdma", HORIZON, trace_mode=m,
                                            decimate=8, channel="trace_replay",
                                            device="cpu")
            for m in ("full", "decimate", "metrics")}
    for f, d, s in zip(rows["full"], rows["decimate"], rows["metrics"]):
        for m in ("goodput_gbps", "wire_gbps", "retx_frac"):
            hi = max(abs(f[m]), abs(d[m]), abs(s[m]), 1e-4)
            assert abs(f[m] - s[m]) / hi < 1e-3, (m, f[m], s[m])
            assert abs(f[m] - d[m]) / hi < 1e-3, (m, f[m], d[m])
        p99 = (abs(f["p99_repair_latency_us"] - s["p99_repair_latency_us"])
               / max(f["p99_repair_latency_us"], s["p99_repair_latency_us"], 1e-3))
        assert p99 < 0.1


def test_schedule_value_grid_is_one_batch():
    cfgs = [_cfg(_timeline(loss=[(2, lr)], cap=[(5, c)])) for lr in (0.0, 0.1)
            for c in (1.0, 0.5)]
    launches = []
    rows = prunner.run_experiment_batch(cfgs, WL, "dcqcn", HORIZON, trace_mode="metrics",
                                        channel="trace_replay", device="cpu",
                                        profile=launches)
    assert len(launches) == 1 and len(rows) == 4
    assert rows[2]["retx_frac"] > rows[0]["retx_frac"] == 0.0


def test_schedule_len_mismatch_raises_as_jax():
    def pair(netconfig):
        a = _cfg(_timeline(), netconfig)
        b = netconfig(distance_km=10.0, channel_schedule=(schedule_from_arrays(
            np.zeros(K + 4, np.float32)),), channel_schedule_dt_us=SLOT_US)
        return [a, b]
    with pytest.raises(ValueError, match="schedule") as j:
        jnetsim.simulate_batch(pair(JNetConfig), jwork.throughput_workload(1 << 20, 16, 4),
                               jnetsim.get_scheme("dcqcn"), HORIZON, channel="trace_replay")
    with pytest.raises(ValueError, match="schedule") as p:
        _run(pair(NetConfig), WL)
    for err in (j.value, p.value):
        assert "channel_schedule lengths differ across the batch ([8, 12])" in str(err)
    with pytest.raises(ValueError, match="schedule"):
        stack_net_params(pair(NetConfig))


def test_schedule_shape_validation():
    with pytest.raises(ValueError, match="channel_schedule"):
        NetConfig(num_paths=2, channel_schedule=(_timeline(),)).schedule_len
    with pytest.raises(ValueError):
        NetConfig(channel_schedule=(_timeline(), _timeline())).schedule_len
    assert NetConfig().schedule_len == 0 and _cfg(_timeline()).schedule_len == K
    assert NetConfig().schedule_array().shape == (1, 0, 3)


def test_schedule_json_roundtrip_and_jax_reads_it(tmp_path):
    sched = (_timeline(loss=[(1, 0.2)], defer=[(2, 0.3)], cap=[(3, 0.5)]), _timeline())
    path = tmp_path / "recorded.json"
    save_schedule_json(path, sched, dt_us=125.0, note="unit fixture")
    loaded, dt = load_schedule_json(path)
    assert dt == 125.0 and loaded == jchannel.load_schedule_json(path)[0]
    np.testing.assert_allclose(np.asarray(loaded, np.float32), np.asarray(sched, np.float32))
    assert NetConfig(num_paths=2, channel_schedule=loaded,
                     channel_schedule_dt_us=dt).schedule_len == K
    jpath = tmp_path / "jax.json"
    jchannel.save_schedule_json(jpath, sched, dt_us=125.0, note="unit fixture")
    assert jpath.read_text() == path.read_text()


def test_schedule_helpers_raise_as_jax(tmp_path):
    for fn in (lambda m: m.schedule_from_arrays([0.1, 0.2], defer=[0.0]),
               lambda m: m.save_schedule_json(tmp_path / "x.json", ((0.1, 0.2),))):
        from repro_torch.netsim import channel as pchannel
        with pytest.raises(ValueError) as j:
            fn(jchannel)
        with pytest.raises(ValueError) as p:
            fn(pchannel)
        assert _msg(p.value) == _msg(j.value)
    bad = tmp_path / "bad.json"
    bad.write_text('{"edges": [{"loss": [0.1, 0.2]}, {"loss": [0.1]}]}')
    with pytest.raises(ValueError, match="edge 1") as p:
        load_schedule_json(bad)
    with pytest.raises(ValueError) as j:
        jchannel.load_schedule_json(bad)
    assert _msg(p.value) == _msg(j.value)


def test_replay_state_leaves_are_jax_shapes():
    """``ReplayState`` per link: ``sched [B, L, K, 3]``, ``defer [B, L, F]``."""
    base = dataclasses.replace(mesh_config(NetConfig, ptopo),
                               channel_schedule=sc._sites_schedule(0.5),
                               channel_schedule_dt_us=SLOT_US)
    _, state, _ = pfl.build_batch([base], mesh_workload(pwork), "dcqcn", device="cpu",
                                  channel="trace_replay")
    shapes = {k: v.shape for k, v in leaves(state.chan).items()}
    assert shapes == {"sched": (1, 4, 8, 3), "defer": (1, 4, 6)}
