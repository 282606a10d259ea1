"""The port's Eq. (1) reservoir model (``core/reservoir.py``) against the JAX
package's on the same numpy inputs, within 1e-6 of each result's scale, and
``tests/test_core_reservoir.py``'s bound-dominates-queue property on the
port. A windowed integral is a difference of two entries of a cumulative
sum, which XLA and torch add up in different orders, so its scale is the
sum's total (the whole horizon's excess), not the window's value."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypo import given, settings, st

import repro.netsim  # noqa: F401  (repro.core imported first is circular)
from repro.core import reservoir as jres
from repro_torch.core import reservoir as pres

DT = 1e-4  # 100 us
REL = 1e-6


def _rates(seed, n, hi_in=100.0, hi_out=80.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, hi_in, n).astype(np.float32),
            rng.uniform(0, hi_out, n).astype(np.float32))


def _close(p, j, scale=None):
    p, j = np.asarray(p, np.float64), np.asarray(j, np.float64)
    assert p.shape == j.shape
    if scale is None:
        scale = np.abs(j).max(initial=0.0)
    assert np.abs(p - j).max(initial=0.0) <= REL * max(scale, 1e-30)


@pytest.mark.parametrize("tau", [1, 10, 123, 500])
@pytest.mark.parametrize("seed", [0, 1])
def test_windowed_integral_and_bound_match_jax(seed, tau):
    r_in, r_out = _rates(seed, 500)
    total = float(jres.required_buffer(jnp.asarray(r_in), jnp.asarray(r_out), DT, 500))
    _close(pres.rate_mismatch_integral(torch.from_numpy(r_in), torch.from_numpy(r_out), DT, tau),
           jres.rate_mismatch_integral(jnp.asarray(r_in), jnp.asarray(r_out), DT, tau), total)
    _close(pres.required_buffer(torch.from_numpy(r_in), torch.from_numpy(r_out), DT, tau),
           jres.required_buffer(jnp.asarray(r_in), jnp.asarray(r_out), DT, tau), total)


@pytest.mark.parametrize("q0", [0.0, 2.5e-3])
@pytest.mark.parametrize("seed", [0, 3])
def test_queue_trajectory_matches_jax(seed, q0):
    r_in, r_out = _rates(seed, 300, 50.0, 50.0)
    _close(pres.queue_trajectory(torch.from_numpy(r_in), torch.from_numpy(r_out), DT, q0),
           jres.queue_trajectory(jnp.asarray(r_in), jnp.asarray(r_out), DT, q0))


def test_analytic_windows_match_jax():
    for d, p, s in ((500.0, 3.0, 100.0), (5.0, 0.0, 0.0)):
        assert pres.control_uncertainty_window_us(d, p, s) == \
            jres.control_uncertainty_window_us(d, p, s)
        assert pres.buffer_bound_e2e_vs_segmented(200e9 / 8, 50e9 / 8, d, s) == \
            jres.buffer_bound_e2e_vs_segmented(200e9 / 8, 50e9 / 8, d, s)


def test_exported_from_core_as_in_jax():
    import repro.core as jcore
    import repro_torch.core as pcore
    names = [n for n in jcore.__all__ if n in dir(jres)]
    assert len(names) == 5 and all(getattr(pcore, n) is getattr(pres, n) for n in names)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 400), st.integers(0, 3))
def test_bound_dominates_queue_property(tau_extra, seed):
    """The windowed bound dominates the growth over any tau window of a queue
    started empty (``tests/test_core_reservoir.py``), on the port."""
    n = 400
    r_in, r_out = (torch.from_numpy(a) for a in _rates(seed, n, 50.0, 50.0))
    tau = tau_extra
    b_req = float(pres.required_buffer(r_in, r_out, DT, tau_steps=max(tau, 1)))
    qs = pres.queue_trajectory(r_in, r_out, DT).numpy()
    growth = []
    for t0 in range(0, n - tau, 17):
        window_growth = qs[t0:t0 + tau] - (qs[t0 - 1] if t0 else 0.0)
        if len(window_growth):
            growth.append(window_growth.max())
    if growth:
        assert b_req >= max(0.0, max(growth)) - 1e-4
