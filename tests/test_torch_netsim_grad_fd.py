"""Finite differences against the port's autograd (tests/test_grad.py's FD
battery, the port alone): for dcqcn and matchrdma on the ``impaired``
channel, every FD knob's central-difference quotient (all ±eps cells in one
batch, at soft_temp 1.0, 4 ms) against the gradient of the unperturbed run,
with tests/test_grad.py's gates: 0.25 relative (0.75, or the same sign, for
the knobs acting through random draws) above the roundoff floor
``3e-5 * max(|objective|, 1) / eps``; and the related-work schemes' own
knobs under the scheme that reads them.
"""
import numpy as np
import pytest

from repro_torch.netsim.grad_tune import FD_EPS, fd_floor
from torch_grad_harness import batch, grads, objective

# (leaf name, central-difference eps): tests/test_grad.py's, one table with
# the card checks (netsim.grad_tune.FD_EPS)
FD_NET_KNOBS = [(n, e) for n, e in FD_EPS.items() if not n.startswith("wl.")]
FD_WL_KNOBS = [(n[3:], e) for n, e in FD_EPS.items() if n.startswith("wl.")]
STOCHASTIC_KNOBS = {"loss_rate", "loss_burst_len", "jitter_us", "flap_depth"}


def _fd_battery(scheme, channel, knobs):
    """``(rows, objective scale)``: (name, eps, fd, ad) for ``knobs`` (names
    of FD_NET_KNOBS and FD_WL_KNOBS)."""
    from repro_torch.config.net import NetParams
    from repro_torch.netsim.workload import WorkloadParams
    net = [(n, e) for n, e in FD_NET_KNOBS if n in knobs]
    wlk = [(n, e) for n, e in FD_WL_KNOBS if n in knobs]
    b = 2 * (len(net) + len(wlk))
    tmpl, steps, warm, dp, hs, params, wlp = batch(b, soft_temp=1.0)
    pi = {n: i for i, n in enumerate(NetParams._fields)}
    wi = {n: i for i, n in enumerate(WorkloadParams._fields)}
    for i, (name, eps) in enumerate(net):
        params[pi[name]][2 * i] += eps
        params[pi[name]][2 * i + 1] -= eps
    for j, (name, eps) in enumerate(wlk):
        i = len(net) + j
        # a uniform shift of every real flow: FD matches the grad summed over flows
        mask = wlp[wi["active_mask"]][2 * i]
        wlp[wi[name]][2 * i] += eps * mask
        wlp[wi[name]][2 * i + 1] -= eps * mask
    obj = objective(tmpl, steps, warm, dp, hs, params, wlp, scheme, channel).astype(np.float64)
    _, g = grads(scheme, channel, soft_temp=1.0)
    rows = []
    for i, (name, eps) in enumerate(net + wlk):
        fd = (obj[2 * i] - obj[2 * i + 1]) / (2.0 * eps)
        ad = float(np.asarray(g["net" if i < len(net) else "wl"][name], np.float64).sum())
        rows.append((name, eps, fd, ad))
    return rows, float(np.mean(np.abs(obj)))


def _check_fd(rows, obj_scale, scheme):
    bad = []
    for name, eps, fd, ad in rows:
        assert np.isfinite(fd) and np.isfinite(ad), (scheme, name)
        floor = fd_floor(obj_scale, eps)
        if max(abs(fd), abs(ad)) <= max(floor, 1e-9):
            continue
        rel = abs(fd - ad) / max(abs(fd), abs(ad))
        gate = 0.75 if name in STOCHASTIC_KNOBS else 0.25
        if name in STOCHASTIC_KNOBS and fd * ad > 0:
            continue  # same sign: magnitude noise is realization noise
        if rel > gate and abs(fd - ad) > floor:
            bad.append(f"{name}: fd={fd:.4e} ad={ad:.4e} rel={rel:.2f}")
    assert not bad, f"{scheme} FD mismatches:\n  " + "\n  ".join(bad)


@pytest.mark.parametrize("scheme", ["dcqcn", "matchrdma"])
def test_fd_matches_grad(scheme):
    knobs = {n for n, _ in FD_NET_KNOBS + FD_WL_KNOBS}
    rows, scale = _fd_battery(scheme, "impaired", knobs)
    _check_fd(rows, scale, scheme)


def test_fd_matches_grad_scheme_knobs():
    """The related-work schemes' own knobs, FD-checked under the scheme that
    reads them (they are dead under dcqcn)."""
    for scheme, knobs in (("geopipe", ("geopipe_credit_bdp_frac",)),
                          ("sdr_rdma", ("sdr_window_bdp_frac", "sdr_ack_coalesce_us",
                                        "sdr_retx_budget_frac"))):
        rows, scale = _fd_battery(scheme, None, set(knobs))
        assert len(rows) == len(knobs)
        _check_fd(rows, scale, scheme)
