"""The port's channel models on their own, mirroring ``tests/test_channel.py``
(the JAX package's): every model invisible at zero knobs (bit-equal to the
port's ideal run, all seven schemes), the loss-repair path (loss bites and is
repaired, conservation under all impairments, repair rows), jitter holding
and releasing, flap throttling, determinism and the seed, the registry's
errors and a custom model end to end. Horizons are cut to a few ms: the
port's CPU path draws its noise in ~500 eager ops a step.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.netsim as jnetsim
from repro_torch.config.net import NetConfig
from repro_torch.netsim import (
    CHANNEL_MODELS, ChannelModel, available_channel_models, get_channel_model,
    register_channel_model,
)
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from repro_torch.netsim.channel import ChannelEffects, unregister_channel_model
from torch_parity import ALL_SCHEMES, SEQ_KW, leaves

WL = pwork.throughput_workload(msg_size=1 << 20, concurrency=1, num_flows=4)
CWL = pwork.congestion_workload(**SEQ_KW)
LOSSY = tuple(m for m in CHANNEL_MODELS if m != "ideal")
_IDEAL = {}


def _run(cfgs, wl, scheme, h, channel=None, **kw):
    return pfl.simulate_batch(cfgs, wl, scheme, h, channel=channel, device="cpu", **kw)


def _ideal(scheme):
    if scheme not in _IDEAL:
        _IDEAL[scheme] = leaves(_run([NetConfig(distance_km=d) for d in (1.0, 100.0)],
                                     WL, scheme, 1_000.0))
    return _IDEAL[scheme]


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
@pytest.mark.parametrize("channel", LOSSY)
def test_zero_knobs_bit_equal_to_ideal(channel, scheme):
    """Every ideal-run leaf (state and traces) bit-equal under a lossy model
    at its default knobs; the model only adds its own leaves."""
    got = leaves(_run([NetConfig(distance_km=d) for d in (1.0, 100.0)], WL, scheme,
                      1_000.0, channel=channel))
    ideal = _ideal(scheme)
    assert set(ideal) <= set(got)
    added = set(got) - set(ideal)
    assert all(k.startswith(("0.chan.", "0.retx_", "1.chan_")) for k in added), added
    diff = [k for k in ideal if not np.array_equal(ideal[k], got[k])]
    assert not diff, diff
    assert float(got["1.chan_lost"].sum()) == 0.0
    assert float(got["1.chan_retx"].sum()) == 0.0


def test_ideal_rows_carry_no_channel_columns():
    r = prunner.run_experiment_batch([NetConfig(distance_km=10.0)], WL, "dcqcn",
                                     500.0, trace_mode="metrics", device="cpu")[0]
    assert "goodput_gbps" not in r and "p99_repair_latency_us" not in r


def test_loss_bites_and_repairs():
    cfg = NetConfig(distance_km=10.0, loss_rate=0.02, loss_burst_len=4.0)
    _, tr = _run([cfg], WL, "dcqcn", 3_000.0, channel="bernoulli_loss")
    assert float(tr["chan_lost"].sum()) > 0 and float(tr["chan_retx"].sum()) > 0
    assert float(tr["cons_err"].max()) < 1e-4
    r = prunner.run_experiment_batch([cfg], WL, "dcqcn", 3_000.0, trace_mode="metrics",
                                     channel="bernoulli_loss", device="cpu")[0]
    assert r["wire_gbps"] > r["goodput_gbps"] > 0
    assert 0 < r["retx_frac"] < 0.5 and r["p99_repair_latency_us"] > 0


@pytest.mark.parametrize("scheme", ("matchrdma", "sdr_rdma", "geopipe"))
def test_conservation_under_full_impairments(scheme):
    cfg = NetConfig(distance_km=100.0, loss_rate=0.01, loss_burst_len=4.0,
                    jitter_us=20.0, flap_period_us=2_000.0, flap_depth=0.5)
    _, tr = _run([cfg], CWL, scheme, 3_000.0, channel="impaired")
    assert float(tr["cons_err"].max()) < 1e-4
    assert float(tr["chan_lost"].sum()) > 0


def test_sdr_retx_budget_engages_on_loss():
    rows = prunner.run_experiment_batch(
        [NetConfig(distance_km=100.0, loss_rate=0.02, loss_burst_len=4.0),
         NetConfig(distance_km=100.0)], WL, "sdr_rdma", 3_000.0,
        trace_mode="metrics", channel="bernoulli_loss", device="cpu")
    assert rows[0]["mean_retx_reserve_frac"] > rows[1]["mean_retx_reserve_frac"]
    assert rows[0]["mean_retx_reserve_frac"] > 0


def test_loss_rate_monotone_in_goodput_gap():
    cfgs = [NetConfig(distance_km=50.0, loss_rate=lr, loss_burst_len=4.0)
            for lr in (0.0, 0.01, 0.05)]
    rows = prunner.run_experiment_batch(cfgs, WL, "dcqcn", 3_000.0,
                                        trace_mode="metrics",
                                        channel="bernoulli_loss", device="cpu")
    gaps = [r["wire_gbps"] - r["goodput_gbps"] for r in rows]
    assert gaps[0] == 0.0 and gaps[0] < gaps[1] < gaps[2], gaps


def test_jitter_holds_and_releases_bytes():
    """Jitter defers fluid without destroying it: the deferral buffer holds
    bytes, conservation counts them, and a finite workload completes."""
    wl = pwork.throughput_workload(msg_size=256 << 10, concurrency=1, num_flows=2)
    wl = pwork.Workload(tuple(dataclasses.replace(f, total_bytes=float(2 << 20))
                              for f in wl.flows))
    cfg = NetConfig(distance_km=10.0, jitter_us=40.0)
    _, tr = _run([cfg], wl, "dcqcn", 2_000.0, channel="jitter")
    assert float(tr["cons_err"].max()) < 1e-4
    r = prunner.run_experiment_batch([cfg], wl, "dcqcn", 2_000.0, trace_mode="metrics",
                                     channel="jitter", device="cpu")[0]
    assert r["completion_frac"] == 1.0


def test_jitter_defers_arrivals():
    cfg = NetConfig(distance_km=10.0, jitter_us=40.0)
    held = []
    _, state, step = pfl.build_batch([cfg], WL, "dcqcn", device="cpu", channel="jitter")
    for t in range(120):
        state, _ = step(state, torch.tensor(t, dtype=torch.int32))
        held.append(float(state.chan.defer.sum()))
    assert max(held) > 0.0


def test_otn_flap_throttles_when_line_is_bottleneck():
    wl = pwork.throughput_workload(4 << 20, 8, num_flows=4)
    cfgs = [NetConfig(distance_km=10.0, num_otn_links=4, flap_period_us=500.0,
                      flap_depth=d) for d in (0.0, 0.5, 0.9)]
    rows = prunner.run_experiment_batch(cfgs, wl, "dcqcn", 3_000.0, trace_mode="metrics",
                                        channel="otn_flap", device="cpu")
    thr = [r["throughput_gbps"] for r in rows]
    assert thr[0] > thr[1] > thr[2], thr


def test_channel_runs_are_deterministic():
    cfg = NetConfig(distance_km=100.0, loss_rate=0.02, jitter_us=20.0)
    a, b = (prunner.run_experiment_batch([cfg], WL, "dcqcn", 1_500.0,
                                         trace_mode="metrics", channel="impaired",
                                         device="cpu")[0] for _ in range(2))
    for k, v in a.items():
        if isinstance(v, float) and np.isfinite(v):
            assert v == b[k], k
    c = prunner.run_experiment_batch([dataclasses.replace(cfg, channel_seed=123)], WL,
                                     "dcqcn", 1_500.0, trace_mode="metrics",
                                     channel="impaired", device="cpu")[0]
    assert c["goodput_gbps"] != a["goodput_gbps"]


def test_builtin_models_registered_as_jax():
    assert CHANNEL_MODELS == jnetsim.CHANNEL_MODELS
    assert set(CHANNEL_MODELS) <= set(available_channel_models())
    for name in CHANNEL_MODELS:
        inst = get_channel_model(name)
        assert inst.name == name and get_channel_model(inst) is inst
        assert inst.is_ideal == jnetsim.get_channel_model(name).is_ideal
    assert get_channel_model(None).name == "ideal"


def test_registry_errors():
    with pytest.raises(ValueError, match="unknown channel model 'nope'"):
        get_channel_model("nope")
    with pytest.raises(ValueError, match="unknown channel model 'nope'"):
        pfl.simulate_batch([NetConfig()], WL, "dcqcn", 10.0, channel="nope",
                           device="cpu")
    name = "_test_dup_channel"
    try:
        register_channel_model(name, ChannelModel())
        with pytest.raises(ValueError, match="already registered"):
            register_channel_model(name, ChannelModel())
        register_channel_model(name, ChannelModel(), override=True)
        with pytest.raises(TypeError, match="expected a ChannelModel"):
            register_channel_model(name, object(), override=True)
    finally:
        unregister_channel_model(name)
    assert name not in available_channel_models()


def test_custom_channel_end_to_end():
    """A model registered by the decorator runs through the engine with no
    engine change: a fixed 50% cut of the line halves a line-bound run."""
    name = "_test_half_line"
    try:
        @register_channel_model(name)
        class HalfLine(ChannelModel):
            is_ideal = False
            needs_key = False

            def apply_impairments(self, ctx, chan, inp):
                return ChannelEffects(arrivals=inp.pipe_out,
                                      lost=torch.zeros_like(inp.pipe_out),
                                      cap_src=inp.cap_src * 0.5, chan=chan)

        wl = pwork.throughput_workload(4 << 20, 8, num_flows=4)
        cfg = NetConfig(distance_km=10.0, num_otn_links=4)
        half, ideal = (prunner.run_experiment_batch([cfg], wl, "dcqcn", 2_000.0,
                                                    trace_mode="metrics", channel=ch,
                                                    device="cpu")[0]
                       for ch in (name, None))
        assert half["throughput_gbps"] < 0.6 * ideal["throughput_gbps"]
        assert half["retx_frac"] == 0.0
    finally:
        unregister_channel_model(name)
