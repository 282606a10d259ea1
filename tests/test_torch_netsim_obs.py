"""The port's observability layer against the JAX package's
(``netsim/obs/events.py`` and ``trace_mode="window"``):

  * ``push_events`` against JAX's on the same candidate streams: overflow
    evicts the oldest, partial firing, the discard slot (never read), an
    unknown kind raising, and an event ring smaller than a step's candidate
    list raising when the run is built;
  * window-mode rows equal to metrics-mode rows bit for bit, for the seven
    schemes, and the window ring equal to full mode's last W steps;
  * the window ring and the event ring against JAX's window mode on the
    golden congestion cell (cut before its recorded parting), the site
    outage of three links (three ``fail_enter`` events at one step) and the
    impaired golden cell: events equal on (time, kind, link), their values
    and the ring within ``TRACE_REL``;
  * ``emit_events`` of matchrdma and sdr_rdma against JAX's on the same
    state pairs.
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import fluid as jfl
from repro.netsim import workload as jwork
from repro.netsim.obs import events as jev
from repro_torch.config.net import NetConfig
from repro_torch.netsim import FailureSchedule
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from repro_torch.netsim.obs import events as pev
from repro_torch.netsim.schemes import get_scheme
from torch_parity import (
    ALL_SCHEMES, IMPAIRED_KNOBS, PARTS, QUEUE_SCALE, SEQ_KW, TRACE_REL,
    assert_traces_close_before,
)

SLOTS = 8


def _stream(seed, steps=12, n_cand=4):
    """Random candidate streams: per step a list of (kind, obj, value,
    fired)."""
    rng = np.random.default_rng(seed)
    kinds = list(jev.EVENT_KINDS)
    names = [kinds[i] for i in rng.integers(0, len(kinds), n_cand)]
    out = []
    for t in range(steps):
        fired = rng.random(n_cand) < 0.6
        vals = rng.normal(size=n_cand).astype(np.float32) * 1e6
        out.append((float(t * 5.0), [(names[i], i, float(vals[i]), bool(fired[i]))
                                     for i in range(n_cand)]))
    return out


def _push_both(stream, slots=SLOTS):
    jr, pr = jev.init_event_ring(slots), pev.init_event_ring(slots)
    for t_us, cands in stream:
        jr = jev.push_events(jr, slots, jnp.float32(t_us), [
            (k, o, jnp.float32(v), jnp.asarray(f)) for k, o, v, f in cands])
        pr = pev.push_events(pr, slots, torch.tensor(t_us), [
            (k, o, torch.tensor(v), torch.tensor(f)) for k, o, v, f in cands])
    return jr, pr


@pytest.mark.parametrize("seed,steps", [(0, 2), (1, 12), (2, 40)])
def test_push_events_matches_jax(seed, steps):
    """Partial firing every step; at 12 and 40 steps the ring has wrapped
    (overflow evicts the oldest, ``count`` keeps growing)."""
    jr, pr = _push_both(_stream(seed, steps))
    assert int(pr.count) == int(jr.count)
    for f in ("t_us", "kind", "obj", "value"):
        assert np.array_equal(getattr(pr, f)[:SLOTS].numpy(),
                              np.asarray(getattr(jr, f))[:SLOTS]), f
    assert pev.decode_events(pr, SLOTS) == jev.decode_events(jr, SLOTS)
    if steps > SLOTS:
        assert int(pr.count) > SLOTS and len(pev.decode_events(pr, SLOTS)) == SLOTS


def test_unfired_candidates_touch_only_the_discard_slot():
    stream = [(5.0, [("pfc_xoff", 0, 1.0, True), ("pfc_xon", 1, 2.0, False)]),
              (10.0, [("pfc_xoff", 0, 3.0, False), ("pfc_xon", 1, 4.0, False)])]
    jr, pr = _push_both(stream)
    assert int(pr.count) == int(jr.count) == 1
    assert pr.kind[:SLOTS].tolist() == [0] + [-1] * (SLOTS - 1)
    assert pr.t_us[:SLOTS].tolist() == [5.0] + [-1.0] * (SLOTS - 1)
    assert pev.decode_events(pr, SLOTS) == jev.decode_events(jr, SLOTS)


def test_batched_ring_pushes_each_cell_as_jax():
    """A ``[B]`` ring against JAX's unbatched ring pushed cell by cell."""
    streams = [_stream(s, 15) for s in (3, 4, 5)]
    pr = pev.init_event_ring(SLOTS, (3,))
    for step in range(15):
        t_us = streams[0][step][0]
        cands = [(k, o, torch.tensor([st[step][1][i][2] for st in streams]),
                  torch.tensor([st[step][1][i][3] for st in streams]))
                 for i, (k, o, _, _) in enumerate(streams[0][step][1])]
        pr = pev.push_events(pr, SLOTS, torch.tensor(t_us), cands)
    for b in range(3):
        st = [(t, [(streams[0][0][1][i][0], i, c[i][2], c[i][3]) for i in range(4)])
              for t, c in streams[b]]
        jr, _ = _push_both(st)
        assert pev.decode_events(pr, SLOTS, cell=b) == jev.decode_events(jr, SLOTS)


def test_unknown_kind_raises_as_jax():
    bad = [("pfc_xoff", 0, 1.0, True), ("not_a_kind", 0, 1.0, True)]
    with pytest.raises(ValueError, match="unknown event kind"):
        jev.push_events(jev.init_event_ring(4), 4, 0.0,
                        [(k, o, jnp.float32(v), jnp.asarray(f)) for k, o, v, f in bad])
    with pytest.raises(ValueError, match="unknown event kind"):
        pev.push_events(pev.init_event_ring(4), 4, torch.tensor(0.0),
                        [(k, o, torch.tensor(v), torch.tensor(f)) for k, o, v, f in bad])
    assert pev.kind_name(12) == jev.kind_name(12) == "kind_12"


def test_undersized_ring_raises_as_jax():
    """dcqcn on one link has three candidates a step: two slots raise."""
    kw = dict(event_ring_slots=2)
    wl = dict(msg_size=1 << 20, concurrency=1, num_flows=2)
    with pytest.raises(ValueError, match="event_ring_slots=2 is smaller"):
        jfl.simulate(dataclasses.replace(JNetConfig(), **kw),
                     jwork.throughput_workload(**wl), jnetsim.get_scheme("dcqcn"),
                     50.0, trace_mode="window")
    with pytest.raises(ValueError, match="event_ring_slots=2 is smaller"):
        pfl.simulate(dataclasses.replace(NetConfig(), **kw), pwork.throughput_workload(**wl),
                     "dcqcn", 50.0, trace_mode="window", device="cpu")


# ---------------------------------------------------------------------------
# Window mode in the port: rows as metrics mode's, ring as full mode's
# ---------------------------------------------------------------------------

def _same(a, b):
    return a == b or (a != a and b != b)


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_window_rows_equal_metrics_rows(scheme):
    cfgs = [dataclasses.replace(NetConfig(distance_km=d), event_ring_slots=16,
                                trace_window_steps=32) for d in (50.0, 300.0)]
    wl = pwork.congestion_workload(**dict(SEQ_KW, horizon_us=1_500.0,
                                          burst_start_us=300.0, burst_len_us=600.0))
    rw, rm = (prunner.run_experiment_batch(cfgs, wl, scheme, 1_500.0, trace_mode=m,
                                           device="cpu") for m in ("window", "metrics"))
    assert len(rw) == len(rm) == 2
    for a, b in zip(rw, rm):
        assert sorted(a) == sorted(b)
        assert all(_same(a[k], b[k]) for k in a), [k for k in a if not _same(a[k], b[k])]


@pytest.mark.parametrize("steps,w", [(150, 64), (40, 64)])
def test_window_ring_is_full_modes_last_steps(steps, w):
    """The ring wrapped (150 steps through 64 rows) and not (40); per-link
    keys at L = 3 included."""
    cfg = dataclasses.replace(NetConfig(distance_km=100.0, num_paths=3,
                                        path_cap_frac=(0.5, 0.3, 0.2)),
                              trace_window_steps=w)
    wl = pwork.congestion_workload(**SEQ_KW)
    h = steps * cfg.dt_us
    _, full = pfl.simulate(cfg, wl, "matchrdma", h, device="cpu")
    _, aux = pfl.simulate(cfg, wl, "matchrdma", h, trace_mode="window", device="cpu")
    assert aux.events is None and sorted(aux.window) == sorted(full)
    idx, ordered = pev.unroll_window(aux.window, steps, w)
    assert idx.tolist() == list(range(max(steps - w, 0), steps))
    for k, v in ordered.items():
        assert np.array_equal(v, full[k][idx].numpy()), k
    assert aux.window["q_dst_link"].shape == (w, 3)


# ---------------------------------------------------------------------------
# Window mode against JAX's
# ---------------------------------------------------------------------------

WINDOW = dict(event_ring_slots=32, trace_window_steps=512)
FLOORS = {k: QUEUE_SCALE for k in ("q_src", "q_dst", "q_leaf", "q_dst_link")}


def _case(name, netconfig, work, fs_cls):
    """(cfg, workload, horizon, channel, part) of a JAX-vs-port case."""
    if name == "seq":
        cfg, wl, h, ch = netconfig(distance_km=100.0), work.congestion_workload(**SEQ_KW), \
            1_500.0, None
    elif name == "site":
        fs = fs_cls.empty(3).site_outage(1, 600.0, 1_500.0, ((0, 1),) * 3)
        cfg = fs.apply(netconfig(distance_km=100.0, num_paths=3,
                                 path_cap_frac=(0.5, 0.3, 0.2)))
        wl, h, ch = work.throughput_workload(1 << 23, 4, 4), 2_500.0, None
    else:
        cfg, wl, h, ch = netconfig(**IMPAIRED_KNOBS), work.congestion_workload(**SEQ_KW), \
            2_500.0, "impaired"
    return dataclasses.replace(cfg, **WINDOW), wl, h, ch


# (matchrdma raises no event on the golden congestion cell in 1.5 ms; its
# brakes fire under the outage and the impaired channel)
CASES = [("seq", s) for s in ("dcqcn", "sdr_rdma")] + \
        [("site", s) for s in ("dcqcn", "matchrdma")] + \
        [("impaired", s) for s in ("dcqcn", "matchrdma")]


@pytest.mark.parametrize("name,scheme", CASES)
def test_window_and_events_match_jax(name, scheme):
    """Every case runs to a horizon before its recorded parting (the golden
    congestion cell parts at step 306 for dcqcn: 300 steps here), with the
    ring holding every step: events equal on (time, kind, link), values
    within TRACE_REL of the largest, the ring's traces as
    ``assert_traces_close_before``."""
    pcfg, pwl, h, ch = _case(name, NetConfig, pwork, FailureSchedule)
    jcfg, jwl, _, _ = _case(name, JNetConfig, jwork, jnetsim.FailureSchedule)
    steps = pcfg.horizon_steps(h)
    assert steps <= PARTS.get((name, scheme), (steps,))[0]
    _, pa = pfl.simulate(pcfg, pwl, scheme, h, trace_mode="window", channel=ch, device="cpu")
    _, ja = jfl.simulate(jcfg, jwl, jnetsim.get_scheme(scheme), h, trace_mode="window",
                         channel=ch)
    pe, je = pev.decode_events(pa.events, 32), jev.decode_events(ja.events, 32)
    assert je, "no events: the case checks nothing"
    assert [(e["t_us"], e["kind"], e["obj"]) for e in pe] == \
        [(e["t_us"], e["kind"], e["obj"]) for e in je]
    scale = max(abs(e["value"]) for e in je) or 1.0
    assert max(abs(a["value"] - b["value"]) for a, b in zip(pe, je)) <= TRACE_REL * scale
    if name == "site":
        assert [e["kind"] for e in pe].count("fail_enter") == 3
    _, pt = pev.unroll_window(pa.window, steps, WINDOW["trace_window_steps"])
    _, jt = jev.unroll_window({k: np.asarray(v) for k, v in ja.window.items()}, steps,
                              WINDOW["trace_window_steps"])
    assert sorted(pt) == sorted(jt)
    assert_traces_close_before({k: v[None] for k, v in pt.items()},
                               {k: v[None] for k, v in jt.items()}, steps,
                               f"{name}/{scheme}", floors=FLOORS)


# ---------------------------------------------------------------------------
# The schemes' emit_events against JAX's on the same state pairs
# ---------------------------------------------------------------------------

def test_matchrdma_brake_fires_where_jax_does():
    rng = np.random.default_rng(0)
    b, f = 6, 5
    t0 = rng.uniform(0.0, 100.0, (b, f)).astype(np.float32)
    t1 = t0 + 5.0
    reset = rng.random((b, f)) < 0.15
    reset[0] = False                                  # a cell where nothing fires
    t1 = np.where(reset, 0.0, t1).astype(np.float32)
    mod = rng.uniform(0.25, 1.0, (b, f)).astype(np.float32)
    pscheme, jscheme = get_scheme("matchrdma"), jnetsim.get_scheme("matchrdma")
    (pk, po, pv, pf), = pscheme.emit_events(
        None, SimpleNamespace(proxy_timer=torch.from_numpy(t0)),
        SimpleNamespace(proxy_timer=torch.from_numpy(t1), proxy_mod=torch.from_numpy(mod)), {})
    for i in range(b):
        (jk, jo, jv, jf), = jscheme.emit_events(
            None, SimpleNamespace(proxy_timer=jnp.asarray(t0[i])),
            SimpleNamespace(proxy_timer=jnp.asarray(t1[i]), proxy_mod=jnp.asarray(mod[i])), {})
        assert (pk, po) == (jk, jo) == ("scheme_brake", 0)
        assert bool(pf[i]) == bool(jf) and float(pv[i]) == float(jv)
    assert not bool(pf[0]) and bool(pf.any())


def test_sdr_rdma_budget_crossings_fire_where_jax_do():
    e0 = np.array([0.2, 0.49, 0.5, 0.7, 0.5, 0.3, 0.51], np.float32)
    e1 = np.array([0.6, 0.5, 0.49, 0.2, 0.5, 0.4, 0.6], np.float32)
    frac = np.array([0.3, 0.95, 0.5, -0.1, 0.2, 0.4, 0.9], np.float32)
    pscheme, jscheme = get_scheme("sdr_rdma"), jnetsim.get_scheme("sdr_rdma")

    def ns(e):
        return SimpleNamespace(extra=SimpleNamespace(cong_ewma=e))

    pc = pscheme.emit_events(
        SimpleNamespace(params=SimpleNamespace(sdr_retx_budget_frac=torch.from_numpy(frac))),
        ns(torch.from_numpy(e0)), ns(torch.from_numpy(e1)), {})
    for i in range(len(e0)):
        jc = jscheme.emit_events(
            SimpleNamespace(params=SimpleNamespace(sdr_retx_budget_frac=jnp.asarray(frac[i]))),
            ns(jnp.asarray(e0[i])), ns(jnp.asarray(e1[i])), {})
        for (pk, po, pv, pf), (jk, jo, jv, jf) in zip(pc, jc):
            assert (pk, po) == (jk, jo)
            assert bool(pf[i]) == bool(jf) and float(pv[i]) == float(jv)
    fired = [[bool(x) for x in c[3]] for c in pc]
    assert fired[0] == [True, True, False, False, False, False, False]
    assert fired[1] == [False, False, True, True, False, False, False]


def test_schemes_without_events_emit_none():
    for s in ("dcqcn", "pseudo_ack", "themis", "geopipe", "rdmacell"):
        assert get_scheme(s).emit_events(None, None, None, {}) == ()
