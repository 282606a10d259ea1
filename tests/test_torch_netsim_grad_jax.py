"""The port's gradients against ``jax.grad`` of the same run: the surrogate
of tests/test_grad.py's harness and its gradient with respect to every
NetParams and WorkloadParams leaf, JAX's ``_run_traced_batch_impl`` under
``jax.grad`` against the port's ``run_traced_batch`` under
``torch.autograd``, for the seven schemes on the ideal channel and dcqcn and
matchrdma on ``impaired``, at tests/test_grad.py's base point at soft_temp
1.0 (its FD temperature), 2 ms: past step 230, where the destination OTN's
queue reaches its PFC threshold, and the pause's way back to the source.

Tolerance: the surrogate within 1e-5 relative; each leaf's gradient within
1e-3 of the larger of its own magnitude and 1e-6 of the surrogate per unit
of the leaf (its largest |value|, at least 1). The discrete workload leaves
(flow kind, mask, routing, sites) are held finite only. At soft_temp 0.3
over 2 ms one ulp of an input moves JAX's own gradients by percents
(tests/test_torch_netsim_grad_cold.py); at 1.0 they stay within 1e-6.
"""
import jax
import numpy as np
import pytest

from repro.config.base import NetConfig as JNetConfig
from repro.netsim import get_scheme as jget
from repro.netsim.fluid import (
    WARMUP_FRAC, _run_traced_batch_impl, as_workload_batch, batch_padding,
    batch_template, stack_net_params,
)
from repro.netsim.workload import throughput_workload as jthroughput
from torch_grad_harness import BASE, DISCRETE_WL, grads
from torch_parity import ALL_SCHEMES

OVER = dict(soft_temp=1.0, horizon_us=2000.0)
CASES = [(s, None) for s in ALL_SCHEMES] + [("dcqcn", "impaired"),
                                            ("matchrdma", "impaired")]


def _jax(scheme, channel, over=OVER):
    cfg = JNetConfig(**{**BASE, **over})
    tmpl = batch_template([cfg])
    steps = tmpl.horizon_steps(None)
    dp, hs = batch_padding([cfg])
    warm = int(steps * WARMUP_FRAC)
    n_warm = max(steps - warm, 1)

    def obj(p, w):
        _, acc = _run_traced_batch_impl(tmpl, p, w, jget(scheme), steps, 0, dp, hs,
                                        mode="metrics", warm=warm, channel=channel)
        s = acc.sum_s
        return (s["thr_inter"] / n_warm * 8.0 / 1e9 - 0.5 * s["q_dst"] / n_warm / 1e6
                - s["pause_dst"] / n_warm)[0]

    params = stack_net_params([cfg])
    val, (gp, gw) = jax.jit(jax.value_and_grad(obj, argnums=(0, 1)))(
        params, as_workload_batch(jthroughput(8e6, 4, num_flows=4), 1))
    return float(val), params, gp, gw


@pytest.mark.parametrize("scheme,channel", CASES)
def test_grads_match_jax(scheme, channel):
    jval, jparams, gp, gw = _jax(scheme, channel)
    pobj, g = grads(scheme, channel, **OVER)
    assert abs(pobj - jval) <= 1e-5 * abs(jval), (pobj, jval)
    for kind, tree in (("net", gp), ("wl", gw)):
        for name in tree._fields:
            a = np.asarray(getattr(tree, name), np.float64)
            b = np.asarray(g[kind][name], np.float64)
            assert a.shape == b.shape and np.isfinite(b).all(), (kind, name)
            if not a.size or (kind == "wl" and name in DISCRETE_WL):
                continue
            x = np.abs(np.asarray(getattr(jparams, name))).max() if kind == "net" else 1.0
            floor = 1e-6 * abs(jval) / max(float(x), 1.0)
            err = np.abs(a - b).max() / max(np.abs(a).max(), floor)
            assert err <= 1e-3, f"{kind}.{name}: jax {a.ravel()[:2]} port {b.ravel()[:2]} ({err:.2e})"
