"""The port's netsim on the card: the CUDA-graph path against the eager steps
bit for bit, the card against the CPU on the golden scenarios (all seven
schemes) and on the two multi-link scenarios of ``tests/torch_parity.py``
(the three-link delay-spread cell and the 3-site mesh), the channel and
failure paths (the threefry draws bit-equal to the CPU's; the impaired golden
cell, the mesh under its replayed schedule and link and site outages, graphs
against eager and card against CPU; the step key folded from a capture-time
step index caught), window mode (the window ring, the event ring and the
streamed accumulators of graphs bit-equal to eager steps; the card's events
equal to the CPU's on the golden congestion cell and a site outage), and the
soft (differentiable) engine: its surrogate and every leaf's gradient against
the CPU's, its checkpointed backward bit-equal to the plain one, and the soft
step in every mode.

These tests import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_netsim_cuda.py

Without a CUDA GPU every test here skips. Card against CPU: the card divides
by a constant as a multiply by its reciprocal and sums in another order, an
ulp a step apart, so the runs are held to the Fig. 3 columns and the final
state with the tolerances the CPU parity tests use (``tests/torch_parity.py``).
"""
import numpy as np
import pytest
import torch

import dataclasses
import itertools

from repro_torch.config.net import NetConfig
from repro_torch.launch import netsim as launch
from repro_torch.netsim import FailureSchedule, fluid, prng
from repro_torch.netsim import topology as ptopo
from repro_torch.netsim import workload as pwork
from torch_parity import (
    ALL_SCHEMES, COLUMN_FLOORS, GOLDEN, IMPAIRED_H_US, IMPAIRED_KNOBS, LINKS3_H_US,
    MESH_H_US, RELATED, SCHEMES, SEQ_KW, assert_columns_close, assert_final_close,
    fig3_columns, golden_configs, golden_workload, leaves, links3_config,
    mesh_config, mesh_workload,
)

# the multi-link scenarios: configs, workload, horizon
LINKS = {"links3": ([links3_config(NetConfig)], golden_workload("seq", pwork),
                    LINKS3_H_US),
         "mesh": ([mesh_config(NetConfig, ptopo)], mesh_workload(pwork), MESH_H_US)}


@pytest.fixture
def cuda():
    """The card; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _run(name, scheme, device, **kw):
    return fluid.simulate_batch(golden_configs(name, NetConfig),
                                golden_workload(name, pwork), scheme,
                                GOLDEN[name][3], device=device, **kw)


@pytest.mark.parametrize("mode", ["full", "metrics"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_graph_matches_eager_bit_for_bit(cuda, scheme, mode):
    kw = dict(trace_mode=mode, horizon_us=512 * 5.0)
    cfgs = golden_configs("batch", NetConfig)
    wl = golden_workload("batch", pwork)
    eager = fluid.simulate_batch(cfgs, wl, scheme, device=cuda, graph_block=0, **kw)
    graph = fluid.simulate_batch(cfgs, wl, scheme, device=cuda, graph_block=100, **kw)
    e, g = leaves(eager), leaves(graph)
    assert sorted(e) == sorted(g) and len(e) > 40
    diff = [k for k in e if not (e[k] == g[k]).all()]
    assert not diff, diff


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_card_matches_cpu(cuda, name, scheme):
    cf, ct = _run(name, scheme, cuda)
    pf, pt = _run(name, scheme, "cpu")
    steps = int(GOLDEN[name][3] / 5.0)
    card = {k: v.cpu().numpy() for k, v in ct.items()}
    cpu = {k: v.numpy() for k, v in pt.items()}
    assert_columns_close(fig3_columns(card, steps), fig3_columns(cpu, steps),
                         f"{name}/{scheme}")
    assert_final_close(cf, pf, 5.0, f"{name}/{scheme}")


@pytest.mark.parametrize("mode", ["full", "metrics"])
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_multilink_graph_matches_eager_bit_for_bit(cuda, scheme, mode):
    cfgs, wl, _ = LINKS["links3"]
    kw = dict(trace_mode=mode, horizon_us=512 * 5.0)
    eager = fluid.simulate_batch(cfgs, wl, scheme, device=cuda, graph_block=0, **kw)
    graph = fluid.simulate_batch(cfgs, wl, scheme, device=cuda, graph_block=100, **kw)
    e, g = leaves(eager), leaves(graph)
    assert sorted(e) == sorted(g) and len(e) > 30
    diff = [k for k in e if not (e[k] == g[k]).all()]
    assert not diff, diff


@pytest.mark.parametrize("scheme", RELATED)
def test_related_graph_matches_eager_bit_for_bit(cuda, scheme):
    kw = dict(horizon_us=512 * 5.0)
    cfgs = golden_configs("batch", NetConfig)
    wl = golden_workload("batch", pwork)
    eager = fluid.simulate_batch(cfgs, wl, scheme, device=cuda, graph_block=0, **kw)
    graph = fluid.simulate_batch(cfgs, wl, scheme, device=cuda, graph_block=100, **kw)
    e, g = leaves(eager), leaves(graph)
    diff = [k for k in e if not (e[k] == g[k]).all()]
    assert sorted(e) == sorted(g) and not diff, diff


@pytest.mark.parametrize("scheme", RELATED)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_related_card_matches_cpu(cuda, name, scheme):
    test_card_matches_cpu(cuda, name, scheme)


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
@pytest.mark.parametrize("name", sorted(LINKS))
def test_multilink_card_matches_cpu(cuda, name, scheme):
    cfgs, wl, h = LINKS[name]
    cf, ct = fluid.simulate_batch(cfgs, wl, scheme, h, device=cuda)
    pf, pt = fluid.simulate_batch(cfgs, wl, scheme, h, device="cpu")
    steps = int(h / 5.0)
    card = {k: v.cpu().numpy() for k, v in ct.items()}
    cpu = {k: v.numpy() for k, v in pt.items()}
    assert card["link_tx"].shape == cpu["link_tx"].shape
    assert_columns_close(fig3_columns(card, steps), fig3_columns(cpu, steps),
                         f"{name}/{scheme}", COLUMN_FLOORS)
    assert_final_close(cf, pf, 5.0, f"{name}/{scheme}")


# the channel and failure scenarios: (configs, workload, horizon, channel)
def _channel_case(name):
    if name == "impaired":
        return ([NetConfig(**IMPAIRED_KNOBS)], pwork.congestion_workload(**SEQ_KW),
                IMPAIRED_H_US, "impaired")
    if name == "sites":
        cfg = dataclasses.replace(mesh_config(NetConfig, ptopo),
                                  channel_schedule=launch.sites_schedule(1.0),
                                  channel_schedule_dt_us=MESH_H_US / 8.0)
        return [cfg], mesh_workload(pwork), MESH_H_US, "trace_replay"
    fs = FailureSchedule.empty(3)
    fs = (fs.link_outage(0, 600.0, 2_000.0) if name == "link0"
          else fs.site_outage(1, 600.0, 1_500.0, ((0, 1),) * 3))
    cfg = fs.apply(NetConfig(distance_km=100.0, num_paths=3, path_cap_frac=(0.5, 0.3, 0.2)))
    return [cfg], pwork.throughput_workload(1 << 23, 4, 4), 3_000.0, None


CHANNEL_CASES = ([("impaired", s) for s in ALL_SCHEMES]
                 + [(n, s) for n in ("sites", "link0", "site")
                    for s in ("dcqcn", "matchrdma", "rdmacell")])


def _graph_vs_eager(cuda, name, scheme, steps=192, graph_block=64):
    cfgs, wl, _, channel = _channel_case(name)
    kw = dict(horizon_us=steps * 5.0, channel=channel, device=cuda)
    eager = fluid.simulate_batch(cfgs, wl, scheme, graph_block=0, **kw)
    graph = fluid.simulate_batch(cfgs, wl, scheme, graph_block=graph_block, **kw)
    e, g = leaves(eager), leaves(graph)
    assert sorted(e) == sorted(g)
    return [k for k in e if not (e[k] == g[k]).all()]


def test_threefry_card_matches_cpu(cuda):
    keys = prng.fold_in(prng.prng_key(7)[None, :], torch.arange(4))
    for shape in ((1 << 20,), (3, 5)):
        a = prng.random_bits(keys, shape)
        b = prng.random_bits(keys.to(cuda), shape).cpu()
        assert torch.equal(a, b)
        assert torch.equal(prng.uniform(keys, shape).view(torch.int32),
                           prng.uniform(keys.to(cuda), shape).cpu().view(torch.int32))


@pytest.mark.parametrize("name,scheme", CHANNEL_CASES)
def test_channel_graph_matches_eager_bit_for_bit(cuda, name, scheme):
    assert not _graph_vs_eager(cuda, name, scheme)


@pytest.mark.parametrize("name,scheme", CHANNEL_CASES)
def test_channel_card_matches_cpu(cuda, name, scheme):
    cfgs, wl, h, channel = _channel_case(name)
    cf, ct = fluid.simulate_batch(cfgs, wl, scheme, h, channel=channel, device=cuda)
    pf, pt = fluid.simulate_batch(cfgs, wl, scheme, h, channel=channel, device="cpu")
    steps = int(h / 5.0)
    card = {k: v.cpu().numpy() for k, v in ct.items()}
    cpu = {k: v.numpy() for k, v in pt.items()}
    assert "chan_lost" in card and card["chan_lost"].sum() > 0
    assert_columns_close(fig3_columns(card, steps), fig3_columns(cpu, steps),
                         f"{name}/{scheme}", COLUMN_FLOORS)
    assert_final_close(cf, pf, 5.0, f"{name}/{scheme}")


def test_step_key_from_capture_time_is_caught(cuda, monkeypatch):
    """Planted: the step key folded from a host-side count read while the
    graph is captured, so every replay draws the captured steps' noise. The
    graphs must then differ from the eager steps."""
    count = itertools.count()
    monkeypatch.setattr(fluid, "step_key",
                        lambda key, t: prng.fold_in(key, next(count)))
    assert _graph_vs_eager(cuda, "impaired", "dcqcn")


# the soft (differentiable) engine: tests/test_grad.py's base point at 2 ms
# (past the destination OTN's PFC threshold), a cell at soft_temp 1.0 and
# one at 0.3 in each batch
SOFT = dict(distance_km=96.0, slot_us=112.0, soft_step=True,
            loss_rate=0.01, loss_burst_len=4.0, jitter_us=20.0,
            flap_period_us=1000.0, flap_depth=0.3, horizon_us=2_000.0)
SOFT_TEMPS = (1.0, 0.3)
# card vs CPU (chip_smoke.py's phase 14 limits) per cell: the surrogate
# relative; the gradient of each FD knob (netsim.grad_tune.FD_EPS, the
# table of tests/test_grad.py and phase 14) relative to the larger
# magnitude of the two, above the FD floor. At 0.3 one ulp of soft_temp
# moves JAX's own run by 1.1e-4 and 14% (tests/test_torch_netsim_grad_cold.py)
SOFT_TOL = ({"surrogate": 1e-4, "grad": 1e-2}, {"surrogate": 1e-3, "grad": 0.75})


def _soft(device, scheme, channel=None, **over):
    from repro_torch.netsim import grad_tune
    return grad_tune.surrogate_grads(
        [NetConfig(**{**SOFT, "soft_temp": t, **over}) for t in SOFT_TEMPS],
        pwork.throughput_workload(8e6, 4, num_flows=4), scheme, channel=channel,
        device=device)


@pytest.mark.parametrize("scheme,channel", [("dcqcn", None), ("matchrdma", "impaired"),
                                            ("geopipe", None), ("sdr_rdma", "impaired")])
def test_soft_surrogate_and_grads_card_vs_cpu(cuda, scheme, channel):
    """The soft engine's surrogate and gradients (autograd through the
    whole run) on the card against the CPU's: every leaf's gradient finite,
    each cell's surrogate and FD knobs' gradients within SOFT_TOL."""
    from repro_torch.netsim.grad_tune import fd_grad_errors
    sc, pc, wc = _soft(cuda, scheme, channel)
    s0, p0, w0 = _soft("cpu", scheme, channel)
    for name, g in leaves((pc, wc)).items():
        assert np.isfinite(g).all(), name
    card = (type(pc)(*(g.cpu() for g in pc)), type(wc)(*(g.cpu() for g in wc)))
    for cell, tol in enumerate(SOFT_TOL):
        s_cpu = float(s0[cell])
        assert abs(float(sc[cell]) - s_cpu) <= tol["surrogate"] * abs(s_cpu), cell
        errs = fd_grad_errors(card, (p0, w0), s_cpu, cell)
        over = {k: e for k, e in errs.items() if not e <= tol["grad"]}
        assert not over, (SOFT_TEMPS[cell], over)


def test_soft_remat_bit_equal_on_the_card(cuda):
    """Checkpointed blocks of 16 steps (remat_steps) give the plain run's
    surrogate and gradients bit for bit on the card."""
    plain = _soft(cuda, "matchrdma", "impaired")
    remat = _soft(cuda, "matchrdma", "impaired", remat_steps=16)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(leaves((plain[1], plain[2])).values(),
                    leaves((remat[1], remat[2])).values()):
        assert (a == b).all()


def test_soft_options_run_on_the_card(cuda):
    """The soft step in the modes and on the links that raised before ROADMAP
    queue 1 item 16: rows finite, the card eager."""
    wl = pwork.throughput_workload(1 << 20, 1, 2)
    for cfg, kw in ((NetConfig(num_paths=2, soft_step=True), {"channel": "jitter"}),
                    (NetConfig(soft_step=True), {}),
                    (NetConfig(soft_step=True), {"trace_mode": "window"})):
        _, aux = fluid.simulate_batch([cfg], wl, "dcqcn", 100.0, device=cuda, **kw)
        assert all(np.isfinite(v).all() for v in leaves(aux).values()
                   if v.dtype.kind == "f")


# window mode: an event ring of 32 slots and a window of 64 steps (so that
# it wraps) on the golden congestion cell and the site outage of three links
WINDOW = dict(event_ring_slots=32, trace_window_steps=64)


def _window_case(name):
    if name == "seq":
        cfgs, wl, h, channel = golden_configs("seq", NetConfig), golden_workload(
            "seq", pwork), GOLDEN["seq"][3], None
    else:
        cfgs, wl, h, channel = _channel_case(name)
    return [dataclasses.replace(c, **WINDOW) for c in cfgs], wl, h, channel


def _window_leaves(run):
    """Every leaf of a window-mode run; the event ring's discard slot (the
    last column, where every candidate that did not fire is written) left
    out."""
    out = leaves(run)
    for k in [k for k in out if ".events." in k and not k.endswith("count")]:
        out[k] = out[k][..., :WINDOW["event_ring_slots"]]
    return out


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_window_graph_matches_eager_bit_for_bit(cuda, scheme):
    cfgs, wl, _, _ = _window_case("seq")
    kw = dict(horizon_us=320 * 5.0, trace_mode="window", device=cuda)
    eager = fluid.simulate_batch(cfgs, wl, scheme, graph_block=0, **kw)
    graph = fluid.simulate_batch(cfgs, wl, scheme, graph_block=64, **kw)
    e, g = _window_leaves(eager), _window_leaves(graph)
    assert sorted(e) == sorted(g) and any(".window." in k for k in e)
    diff = [k for k in e if not (e[k] == g[k]).all()]
    assert not diff, diff


@pytest.mark.parametrize("scheme", ("dcqcn", "matchrdma", "sdr_rdma"))
@pytest.mark.parametrize("name", ("seq", "site"))
def test_window_card_matches_cpu(cuda, name, scheme):
    """The same events (time, kind, link) in the same order, their values
    within FINAL_REL of the largest, the window rings and the final state
    as the CPU's."""
    from repro_torch.netsim.obs import decode_events
    from torch_parity import FINAL_REL

    cfgs, wl, h, channel = _window_case(name)
    runs = [fluid.simulate_batch(cfgs, wl, scheme, h, trace_mode="window",
                                 channel=channel, device=d) for d in (cuda, "cpu")]
    (cf, ca), (pf, pa) = runs
    ec, ep = (decode_events(a.events, WINDOW["event_ring_slots"], cell=0) for a in (ca, pa))
    assert [(e["t_us"], e["kind"], e["obj"]) for e in ec] == \
        [(e["t_us"], e["kind"], e["obj"]) for e in ep]
    scale = max([abs(e["value"]) for e in ep] + [1.0])
    assert max([abs(a["value"] - b["value"]) for a, b in zip(ec, ep)] + [0.0]) <= FINAL_REL * scale
    if name == "site":
        assert [e["kind"] for e in ep].count("fail_enter") == 3
    assert_final_close(cf, pf, 5.0, f"{name}/{scheme}")
