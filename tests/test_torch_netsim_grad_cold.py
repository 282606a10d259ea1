"""Why the soft engine's gradients are held loosely at soft_temp 0.3: at
tests/test_grad.py's base point over 2 ms, one f32 ulp of soft_temp moves
JAX's own surrogate by up to 1.1e-4 and its FD knobs' gradients by up to
14% (dcqcn and sdr_rdma on the ideal channel; the gates are steep at 0.3,
so f32 rounding anywhere in the run moves where the rate and pause gates
sit). The port's CPU run, which rounds otherwise, parts from JAX's by no
more than that nudge does; at 1.0 the two agree to 1e-7
(tests/test_torch_netsim_grad_jax.py). chip_smoke.py's phase 14 and the
card tests read their 0.3 limits off this.

Errors: the surrogate relative to JAX's; each FD knob's gradient
(``netsim.grad_tune.FD_EPS``) relative to the larger magnitude, above the FD
floor (``netsim.grad_tune.fd_grad_errors``).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.config.net import NetParams
from repro_torch.netsim.grad_tune import fd_grad_errors
from repro_torch.netsim.workload import WorkloadParams
from test_torch_netsim_grad_jax import _jax
from torch_grad_harness import grads

COLD = dict(soft_temp=0.3, horizon_us=2000.0)


def _up(x, k):
    """``x`` moved by ``k`` f32 ulps."""
    x = np.float32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf), dtype=np.float32)
    return float(x)


def _pair(net, wl):
    return (NetParams(*(torch.tensor(np.array(getattr(net, f))) for f in NetParams._fields)),
            WorkloadParams(*(torch.tensor(np.array(getattr(wl, f)))
                             for f in WorkloadParams._fields)))


def _drift(run, ref):
    """(surrogate error, worst FD-knob gradient error) of ``run`` against
    ``ref``, both ``(surrogate, grads pair)``."""
    errs = fd_grad_errors(run[1], ref[1], ref[0])
    return abs(run[0] - ref[0]) / abs(ref[0]), max(errs.values())


@pytest.mark.parametrize("scheme", ["dcqcn", "sdr_rdma"])
def test_cold_drift_within_one_ulp_of_soft_temp(scheme):
    def jrun(over):
        val, _, gp, gw = _jax(scheme, None, over)
        return val, _pair(gp, gw)

    ref = jrun(COLD)
    nudged = [_drift(jrun({**COLD, "soft_temp": _up(0.3, k)}), ref) for k in (-1, 1)]
    surr, g = grads(scheme, None, **COLD)
    port = _drift((surr, _pair(SimpleNamespace(**g["net"]), SimpleNamespace(**g["wl"]))),
                  ref)
    ulp_s, ulp_g = max(n[0] for n in nudged), max(n[1] for n in nudged)
    # the nudge moves the run, and the port's drift is no larger
    assert ulp_g >= 1e-2, nudged
    assert port[0] <= ulp_s and port[1] <= ulp_g, (port, nudged)
