"""Gradients of the port's soft-step engine (mirroring tests/test_grad.py):

  * finiteness: ``torch.autograd`` of the streamed surrogate with respect to
    every NetParams and WorkloadParams leaf is finite, for the seven schemes
    (the impaired channel for dcqcn and matchrdma), at tests/test_grad.py's
    base point cut to 2 ms;
  * ``remat_steps``: checkpointed blocks of k steps give the plain run's
    surrogate and gradients bit for bit;
  * a ``slot_us`` sweep (a per-scenario leaf) as one batch equal to the
    single-cell runs at matching values, rtol 1e-5 (hard engine, metrics).

tests/test_torch_netsim_grad_jax.py holds the gradients against
``jax.grad``, tests/test_torch_netsim_grad_fd.py against finite differences.
"""
import numpy as np
import pytest

from repro_torch.config.net import NetConfig
from repro_torch.netsim import fluid, run_experiment, run_experiment_batch
from repro_torch.netsim.schemes import ALL_SCHEMES
from repro_torch.netsim.workload import throughput_workload
from torch_grad_harness import grads


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_grad_finite_every_leaf(scheme):
    channel = "impaired" if scheme in ("dcqcn", "matchrdma") else None
    obj, g = grads(scheme, channel, horizon_us=2000.0)
    assert np.isfinite(obj)
    for kind in ("net", "wl"):
        for name, leaf in g[kind].items():
            assert np.isfinite(leaf).all(), f"{scheme}: non-finite grad in {kind} leaf {name!r}"
    # the temperature reaches the surrogate in every scheme
    assert abs(g["net"]["soft_temp"]).sum() > 0


def test_remat_steps_bit_equal():
    """remat_steps = 16 (torch.utils.checkpoint over blocks of 16 steps, the
    rest plain) against 0: the same surrogate and gradients, bit for bit."""
    plain = grads("matchrdma", "impaired", horizon_us=1000.0)
    remat = grads("matchrdma", "impaired", horizon_us=1000.0, remat_steps=16)
    np.testing.assert_array_equal(plain[0], remat[0])
    for kind in ("net", "wl"):
        for name in plain[1][kind]:
            np.testing.assert_array_equal(plain[1][kind][name], remat[1][kind][name],
                                          err_msg=f"{kind}.{name}")


def test_slot_sweep_equals_single_cells():
    """slot_us is a per-scenario leaf: a sweep runs as one batch, and each
    row equals the single-cell run at that value (whose template is built
    from it), within rtol 1e-5, as tests/test_grad.py pins JAX's."""
    wl = throughput_workload(8e6, 4, num_flows=4)
    slots = (50.0, 100.0, 200.0, 400.0)
    cfgs = [NetConfig(distance_km=100.0, horizon_us=6000.0, slot_us=s) for s in slots]
    other = [NetConfig(distance_km=100.0, horizon_us=6000.0, slot_us=s)
             for s in (64.0, 112.0, 250.0, 320.0)]
    dp, hs = fluid.batch_padding(cfgs + other)
    rows = run_experiment_batch(cfgs, wl, "matchrdma", 6000.0, trace_mode="metrics",
                                delay_pad=dp, history_slots=hs, device="cpu")
    assert len(run_experiment_batch(other, wl, "matchrdma", 6000.0,
                                    trace_mode="metrics", delay_pad=dp,
                                    history_slots=hs, device="cpu")) == 4
    for cfg, row in zip(cfgs, rows):
        ref = run_experiment(cfg, wl, "matchrdma", 6000.0, trace_mode="metrics",
                             delay_pad=dp, history_slots=hs, device="cpu")
        for k in ("throughput_gbps", "pause_ratio", "mean_buffer_mb"):
            assert np.isclose(row[k], ref[k], rtol=1e-5, atol=1e-9), \
                (cfg.slot_us, k, row[k], ref[k])
