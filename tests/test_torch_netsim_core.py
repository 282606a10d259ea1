"""The port's netsim leaf math against the JAX package, on the same numpy
inputs: config and workload copies, queues, streaming reductions, the DCQCN
machine, slots, estimator, budget, pseudo-ACK and MatchRDMA's slot update.

Batched cases run the JAX function under ``jax.vmap`` and the port's on the
``[B]`` axis. Tolerances: host-side copies (configs, workloads, NetParams)
are bit-equal; integer leaves (ring indices, histogram bins) are equal;
float leaves agree within 1e-6 of each leaf's largest value (``REL``): the
same f32 operations in the same order, except that XLA on the CPU contracts
multiply-adds into FMAs where torch rounds each operation, which moves a
value by an ulp (1.2e-7 relative) or a few where values cancel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.netsim  # noqa: F401  (first: repro.core and repro.netsim import each other)
import repro.config.base as jbase
import repro.core.budget as jbudget
import repro.core.cc_proxy as jcc
import repro.core.estimator as jest
import repro.core.matchrdma as jmr
import repro.core.pseudo_ack as jpa
import repro.core.slots as jslots
import repro.netsim.queues as jq
import repro.netsim.streaming as jstream
import repro.netsim.workload as jwork
import repro_torch.config.net as pbase
import repro_torch.core.budget as pbudget
import repro_torch.core.cc_proxy as pcc
import repro_torch.core.estimator as pest
import repro_torch.core.matchrdma as pmr
import repro_torch.core.pseudo_ack as ppa
import repro_torch.core.slots as pslots
import repro_torch.netsim.queues as pq
import repro_torch.netsim.streaming as pstream
import repro_torch.netsim.workload as pwork
from repro_torch.netsim.schemes import get_scheme
from torch_parity import assert_close, leaves

REL = 1e-6
DISTS = (1.0, 100.0, 300.0, 1000.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _params(dists=DISTS, **kw):
    jc = [jbase.NetConfig(distance_km=d, **kw) for d in dists]
    pc = [pbase.NetConfig(distance_km=d, **kw) for d in dists]
    return jc, pc, jbase.stack_net_params(jc), pbase.stack_net_params(pc)


# ---------------------------------------------------------------- copies


def test_netconfig_fields_and_defaults_are_the_jax_packages():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jbase.NetConfig)]
    pf = [(f.name, f.type, f.default) for f in dataclasses.fields(pbase.NetConfig)]
    assert pf == jf
    assert pbase.NET_TRACED_FIELDS == jbase.NET_TRACED_FIELDS


@pytest.mark.parametrize("kw", [
    dict(distance_km=100.0), dict(distance_km=0.7, dt_us=2.0),
    dict(distance_km=333.3, slot_us=70.0, dt_us=3.0), dict(num_otn_links=4),
])
def test_netconfig_host_helpers_and_netparams_are_equal(kw):
    jc, pc = jbase.NetConfig(**kw), pbase.NetConfig(**kw)
    for name in ("static_delay_steps", "control_proc_steps", "one_way_delay_us",
                 "otn_capacity_gbps"):
        assert getattr(pc, name) == getattr(jc, name), name
    assert pc.horizon_steps(12_345.0) == jc.horizon_steps(12_345.0)
    jp, pp = jbase.NetParams.of(jc), pbase.NetParams.of(pc)
    for k, v in leaves(jp).items():
        got = leaves(pp)[k]
        assert got.dtype == np.float32 and np.array_equal(got, v), k
    assert int(pp.delay_steps(pc.dt_us)) == int(jp.delay_steps(jc.dt_us))


def test_stack_net_params_and_batch_template_are_equal():
    jc, pc, jp, pp = _params(slot_us=100.0)
    for k, v in leaves(jp).items():
        got = leaves(pp)[k]
        assert got.dtype == np.float32 and np.array_equal(got, v), k
    assert dataclasses.asdict(pbase.batch_template(pc)) == \
        dataclasses.asdict(jbase.batch_template(jc))
    with pytest.raises(ValueError, match="must be identical"):
        pbase.batch_template([pbase.NetConfig(), pbase.NetConfig(dt_us=2.0)])


@pytest.mark.parametrize("build,args", [
    ("throughput_workload", dict(msg_size=1 << 20, concurrency=3, num_flows=5)),
    ("congestion_workload", dict(num_inter=4, num_intra=3)),
    ("mixed_fct_workload", dict(msg_size=64 << 10)),
])
def test_workload_arrays_are_equal(build, args):
    jw, pw = getattr(jwork, build)(**args), getattr(pwork, build)(**args)
    for k, v in jw.arrays().items():
        assert np.array_equal(pw.arrays()[k], v), k
    jl = jwork.stack_workload_params([jw, jwork.throughput_workload(1 << 10, 1, 2)])
    pl = pwork.stack_workload_params([pw, pwork.throughput_workload(1 << 10, 1, 2)])
    for k, v in leaves(jl).items():
        assert np.array_equal(leaves(pl)[k], v), k


def test_unported_schemes_raise_by_name():
    """Every scheme of the JAX package resolves in the port (the related-work
    pack came with the multi-link slice); an unknown name raises."""
    from repro.netsim.schemes import ALL_SCHEMES as JAX_ALL
    from repro_torch.netsim.schemes import ALL_SCHEMES
    assert ALL_SCHEMES == JAX_ALL
    for name in ALL_SCHEMES:
        assert get_scheme(name).name == name
    with pytest.raises(ValueError, match="unknown scheme"):
        get_scheme("nope")


# ---------------------------------------------------------------- queues


def test_queues_match():
    rng = np.random.default_rng(0)
    jc, pc, jp, pp = _params()
    b, f = len(DISTS), 6
    q = rng.uniform(0, 4e6, (b, f)).astype(np.float32)
    q[0] = 0.0                                     # an empty queue: no drain
    arr = rng.uniform(0, 1e6, (b, f)).astype(np.float32)
    cap = rng.uniform(0, 8e6, (b,)).astype(np.float32)
    tot = q.sum(1)
    paused = (rng.uniform(size=b) > 0.5).astype(np.float32)
    jnq, jdr = jax.vmap(jq.drain_proportional)(_j(q), _j(arr), _j(cap))
    pnq, pdr = pq.drain_proportional(_t(q), _t(arr), _t(cap))
    assert_close((pnq, pdr), (jnq, jdr), REL, what="drain_proportional")
    jm = jax.vmap(lambda x, p: jq.ecn_mark_prob(x, jc[0], params=p))(_j(tot), jp)
    pm = pq.ecn_mark_prob(_t(tot), pc[0], params=pp)
    assert_close(pm, jm, REL, what="ecn_mark_prob")
    for xoff in (2e6, 1.5e7):
        jh = jq.pfc_hysteresis(_j(paused), _j(tot), xoff, xoff / 2)
        ph = pq.pfc_hysteresis(_t(paused), _t(tot), xoff, xoff / 2)
        assert np.array_equal(ph.numpy(), np.asarray(jh))


# ---------------------------------------------------------------- streaming


def test_hist_bins_and_quantile_match():
    rng = np.random.default_rng(1)
    x = np.concatenate([[0.0, 0.5, 1.0, 1e12, 5e12],
                        10 ** rng.uniform(-1, 12.5, 20_000)]).astype(np.float32)
    jb = np.asarray(jstream.hist_bin_index(_j(x)))
    pb = pstream.hist_bin_index(_t(x)).numpy()
    assert np.array_equal(pb, jb)
    hist = rng.integers(0, 50, (3, pstream.HIST_BINS))
    assert np.array_equal(pstream.hist_quantile(hist, 0.99),
                          jstream.hist_quantile(hist, 0.99))


def test_kahan_sum_is_bit_equal():
    xs = np.random.default_rng(2).uniform(0, 5e10, (1000, 3)).astype(np.float32)

    def jstep(c, x):
        return jstream.kahan_add(c[0], c[1], x), None

    (js, jc), _ = jax.lax.scan(jstep, (jnp.zeros(3), jnp.zeros(3)), _j(xs))
    ps = pc = torch.zeros(3)
    for x in _t(xs):
        ps, pc = pstream.kahan_add(ps, pc, x)
    assert np.array_equal(ps.numpy(), np.asarray(js))
    assert np.array_equal(pc.numpy(), np.asarray(jc))


# ---------------------------------------------------------------- DCQCN


def _dcqcn_state(rng, shape):
    line = 5e10
    return dict(
        rc=rng.uniform(1e7, line, shape), rt=rng.uniform(1e7, line, shape),
        alpha=rng.uniform(0, 1, shape),
        t_alpha=rng.choice([0.0, 45.0, 50.0, 55.0], shape),
        t_rate=rng.choice([0.0, 290.0, 295.0, 300.0], shape),
        bytes_ctr=rng.choice([0.0, 9.99e6, 1e7 - 62_500.0], shape),
        stage_t=rng.integers(0, 8, shape).astype(float),
        stage_b=rng.integers(0, 8, shape).astype(float))


@pytest.mark.parametrize("themis", [False, True])
def test_step_dcqcn_matches(themis):
    rng = np.random.default_rng(3)
    shape = (4, 64)
    st = {k: v.astype(np.float32) for k, v in _dcqcn_state(rng, shape).items()}
    cnp = (rng.uniform(size=shape) > 0.7).astype(np.float32)
    sent = rng.choice([0.0, 62_500.0, 250_000.0], shape).astype(np.float32)
    rtt = rng.uniform(4.0, 2e4, shape).astype(np.float32)
    cfg_j, cfg_p = jbase.NetConfig(), pbase.NetConfig()
    j_scale = jcc.themis_rtt_scale(_j(rtt)) if themis else None
    p_scale = pcc.themis_rtt_scale(_t(rtt)) if themis else None
    if themis:
        assert_close(p_scale, j_scale, REL, what="themis_rtt_scale")
    for _ in range(3):       # three steps, each from the JAX state
        js = jcc.DcqcnState(**{k: _j(v) for k, v in st.items()})
        ps = pcc.DcqcnState(**{k: _t(v) for k, v in st.items()})
        jn = jcc.step_dcqcn(js, _j(cnp), _j(sent), cfg_j, rtt_scale=j_scale)
        pn = pcc.step_dcqcn(ps, _t(cnp), _t(sent), cfg_p, rtt_scale=p_scale)
        assert_close(pn, jn, REL, what="step_dcqcn")
        st = {k: np.asarray(v) for k, v in jn._asdict().items()}
    init_j = jcc.init_dcqcn(5, 5e10)
    init_p = pcc.init_dcqcn(5, torch.tensor(5e10))
    assert_close(init_p, init_j, 0.0, what="init_dcqcn")


# ---------------------------------------------------------------- slots, estimator


def _rings(rng, b, r, count):
    rates = rng.uniform(0, 5e10, (b, r)).astype(np.float32)
    # stable stretches, so some windows pass the CV gate
    rates[:, : r // 2] = rates[:, :1]
    cong = (rng.uniform(size=(b, r)) > 0.8).astype(np.float32)
    busy = (rng.uniform(size=(b, r)) > 0.5).astype(np.float32)
    idx = rng.integers(0, r, b).astype(np.int32)
    cnt = np.asarray(count, np.int32)
    return dict(rates=rates, congested=cong, busy=busy, idx=idx, count=cnt)


def test_slot_ring_push_and_history_match():
    rng = np.random.default_rng(4)
    cfg_j, cfg_p = jbase.NetConfig(), pbase.NetConfig()
    ring = _rings(rng, 4, 16, [0, 5, 16, 40])
    obs = [rng.uniform(0, x, 4).astype(np.float32)
           for x in (5e10, 60.0, 3.0, 1e6)]
    jr = jslots.SlotRing(**{k: _j(v) for k, v in ring.items()})
    pr = pslots.SlotRing(**{k: _t(v) for k, v in ring.items()})
    jo = jslots.SlotObs(*map(_j, obs))
    po = pslots.SlotObs(*map(_t, obs))
    assert np.array_equal(pslots.classify_slot(po, cfg_p).numpy(),
                          np.asarray(jax.vmap(lambda o: jslots.classify_slot(o, cfg_j))(jo)))
    jn = jax.vmap(lambda r, o: jslots.push_slot(r, o, cfg_j))(jr, jo)
    pn = pslots.push_slot(pr, po, cfg_p)
    assert_close(pn, jn, 0.0, what="push_slot")
    jh = jax.vmap(jslots.ordered_history)(jn)
    ph = pslots.ordered_history(pn)
    assert_close(ph, jh, 0.0, what="ordered_history")


@pytest.mark.parametrize("period", [0, 16])
def test_estimators_match(period):
    rng = np.random.default_rng(5 + period)
    cfg_j, cfg_p = jbase.NetConfig(), pbase.NetConfig()
    ring = _rings(rng, 6, 64, [0, 3, 20, 64, 64, 200])
    if period:
        # a recurrence in the fully written rings
        ring["rates"][3:] = np.tile(np.repeat([9e9, 2e9], 8), 4)
    jr = jslots.SlotRing(**{k: _j(v) for k, v in ring.items()})
    pr = pslots.SlotRing(**{k: _t(v) for k, v in ring.items()})
    if period:
        je = jax.vmap(lambda r: jest.periodic_estimate(r, cfg_j, period))(jr)
        pe = pest.periodic_estimate(pr, cfg_p, period)
        assert float(pe.recurrent.sum()) > 0
    else:
        je = jax.vmap(lambda r: jest.slot_weighted_estimate(r, cfg_j))(jr)
        pe = pest.slot_weighted_estimate(pr, cfg_p)
    # mean/std over a window round differently (torch's std is one pass)
    assert_close(pe, je, 1e-5, what="estimate")


# ---------------------------------------------------------------- budget, pseudo-ACK


def test_update_budget_matches():
    rng = np.random.default_rng(6)
    jc, pc, jp, pp = _params()
    b = len(DISTS)
    for have in (0.0, 1.0):
        st = dict(budget=rng.uniform(1e8, 2e11, b), tighten=rng.uniform(0.7, 1, b),
                  slots_clear=rng.integers(0, 30, b).astype(float),
                  cap_ewma=rng.uniform(1e9, 5e10, b), have_cap=np.full(b, have))
        est = dict(rate=rng.uniform(1e9, 5e10, b), stable_frac=rng.uniform(0, 1, b),
                   recurrent=np.zeros(b), capability=rng.uniform(1e9, 5e10, b),
                   have_capability=(rng.uniform(size=b) > 0.5).astype(float))
        cnp = rng.choice([0.0, 1.0, 3.0], b)
        cong = rng.choice([0.0, 0.01, 0.5], b)
        ctrl = rng.choice([4.0, 5.0, 21.0], b)
        cast = {k: v.astype(np.float32) for k, v in st.items()}
        caste = {k: v.astype(np.float32) for k, v in est.items()}
        jn = jax.vmap(lambda s, e, c, g, k, p: jbudget.update_budget(
            s, e, c, g, jc[0], ctrl_slots=k, params=p))(
            jbudget.BudgetState(**{k: _j(v) for k, v in cast.items()}),
            jest.RateEstimate(**{k: _j(v) for k, v in caste.items()}),
            _j(cnp.astype(np.float32)), _j(cong.astype(np.float32)),
            _j(ctrl.astype(np.float32)), jp)
        pn = pbudget.update_budget(
            pbudget.BudgetState(**{k: _t(v) for k, v in cast.items()}),
            pest.RateEstimate(**{k: _t(v) for k, v in caste.items()}),
            _t(cnp.astype(np.float32)), _t(cong.astype(np.float32)), pc[0],
            ctrl_slots=_t(ctrl.astype(np.float32)), params=pp)
        assert_close(pn, jn, REL, what="update_budget")
    assert_close(pbudget.init_budget(pc[0]), jbudget.init_budget(jc[0]), 0.0)
    assert_close(pbudget.init_budget(pc[0], pp),
                 jax.vmap(lambda p: jbudget.init_budget(jc[0], p))(jp), 0.0)


def test_control_channel_and_fair_share_match():
    rng = np.random.default_rng(7)
    jc, pc, jp, pp = _params()
    actual = np.array([3, 1, 7, 8], np.int32)
    jch = jax.vmap(lambda p, a: jbudget.init_channel(8, jc[0], params=p,
                                                     actual_delay=a))(jp, _j(actual))
    pch = pbudget.init_channel(8, pc[0], params=pp, actual_delay=_t(actual))
    assert_close(pch, jch, 0.0, what="init_channel")
    send = jax.jit(jax.vmap(jbudget.channel_send_recv))
    for _ in range(20):
        budget = rng.uniform(1e9, 5e10, 4).astype(np.float32)
        summ = (rng.uniform(size=4) > 0.5).astype(np.float32)
        jch, jb, js = send(jch, _j(budget), _j(summ))
        pch, pb, ps = pbudget.channel_send_recv(pch, _t(budget), _t(summ))
        assert_close((pch, pb, ps), (jch, jb, js), 0.0, what="channel_send_recv")
    act = (rng.uniform(size=(4, 6)) > 0.4).astype(np.float32)
    tot = rng.uniform(1e9, 5e10, 4).astype(np.float32)
    assert_close(pbudget.fair_share(_t(tot), _t(act)),
                 jax.vmap(jbudget.fair_share)(_j(tot), _j(act)), REL)


@pytest.mark.parametrize("gated", [False, True])
def test_step_pseudo_ack_matches(gated):
    rng = np.random.default_rng(8)
    packed = rng.uniform(0, 1e9, (3, 5)).astype(np.float32)
    credits = rng.uniform(0, 1e7, (3, 5)).astype(np.float32)
    accepted = (packed + rng.uniform(0, 1e6, (3, 5))).astype(np.float32)
    share = rng.uniform(0, 1e10, (3, 5)).astype(np.float32)
    jn = jpa.step_pseudo_ack(jpa.PseudoAckState(_j(packed), _j(credits)),
                             _j(accepted), _j(share), 5e-6, gated=gated)
    pn = ppa.step_pseudo_ack(ppa.PseudoAckState(_t(packed), _t(credits)),
                             _t(accepted), _t(share), 5e-6, gated=gated)
    assert_close(pn, jn, REL, what="step_pseudo_ack")


# ---------------------------------------------------------------- MatchRDMA


def _mr_states(seed):
    """A JAX MatchRdmaState batch with random accumulators and a random
    ring, and the port's copy of it."""
    from repro_torch.netsim.convert import state_from_numpy
    rng = np.random.default_rng(seed)
    jc, pc, jp, pp = _params()
    pad = max(c.static_delay_steps for c in jc) + jc[0].control_proc_steps
    hs = max(jmr.default_history_slots(c) for c in jc)
    tmpl_j, tmpl_p = jbase.batch_template(jc), pbase.batch_template(pc)
    st = jax.vmap(lambda p: jmr.init_matchrdma(tmpl_j, 4, hs, p, pad))(jp)
    b = len(DISTS)
    ring = _rings(rng, b, hs, [0, 7, hs, 3 * hs])
    acc = dict(acc_egress=rng.uniform(0, 2e8, b), acc_cnp=rng.choice([0.0, 1.0, 4.0], b),
               acc_ack_delay=rng.uniform(0, 800, b), acc_ack_n=np.full(b, 20.0),
               acc_queue=rng.uniform(0, 3e8, b), acc_paused=rng.choice([0.0, 5.0, 19.0], b))
    st = st._replace(ring=jslots.SlotRing(**{k: _j(v) for k, v in ring.items()}),
                     **{k: _j(v.astype(np.float32)) for k, v in acc.items()})
    np_st = jax.tree.map(np.asarray, st)
    return (tmpl_j, tmpl_p, jp, pp, st, state_from_numpy(np_st))


def test_init_matchrdma_matches():
    jc, pc, jp, pp = _params()
    tmpl_j, tmpl_p = jbase.batch_template(jc), pbase.batch_template(pc)
    pad = max(c.static_delay_steps for c in jc) + jc[0].control_proc_steps
    jst = jax.vmap(lambda p: jmr.init_matchrdma(tmpl_j, 4, 64, p, pad))(jp)
    pst = pmr.init_matchrdma(tmpl_p, 4, 64, pp, pad)
    assert_close(pst, jst, 0.0, what="init_matchrdma")


def test_slot_update_matches():
    tmpl_j, tmpl_p, jp, pp, jst, pst = _mr_states(9)
    jn = jax.vmap(lambda s, p: jmr.slot_update(s, tmpl_j, 0, params=p))(jst, jp)
    pn = pmr.slot_update(pst, tmpl_p, 0, params=pp)
    assert_close(pn, jn, 1e-5, what="slot_update")


@pytest.mark.parametrize("t", [18, 19, 39])
def test_maybe_slot_update_and_channel_match(t):
    tmpl_j, tmpl_p, jp, pp, jst, pst = _mr_states(10)
    jn = jax.vmap(lambda s, p: jmr.maybe_slot_update(
        s, tmpl_j, jnp.int32(t), 0, params=p))(jst, jp)
    pn = pmr.maybe_slot_update(pst, tmpl_p, torch.tensor(t, dtype=torch.int32),
                               0, params=pp)
    assert_close(pn, jn, 1e-5, what="maybe_slot_update")
    over = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    jn = jax.vmap(jmr.step_channel)(jn, _j(over))
    pn = pmr.step_channel(pn, _t(over))
    assert_close(pn, jn, 1e-5, what="step_channel")
    jn = jax.vmap(lambda s: jmr.accumulate_step(
        s, jnp.float32(3e5), jnp.float32(1.0), jnp.float32(2.5),
        jnp.float32(1.0), jnp.float32(7e6), jnp.float32(1.0)))(jn)
    pn = pmr.accumulate_step(pn, 3e5, 1.0, 2.5, 1.0, 7e6, 1.0)
    assert_close(pn, jn, 1e-5, what="accumulate_step")
