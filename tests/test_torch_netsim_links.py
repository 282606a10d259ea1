"""Teacher-forced single steps of the port's multi-link engine against the
JAX package's, for the seven schemes on the two multi-link scenarios of
``tests/torch_parity.py``: the delay-spread cell ``LINKS3`` (three links,
2000 steps) and the 3-site mesh (four edges, 1200 steps). At sampled steps
the JAX state (``[L]`` leaves and every scheme's extra state included) is
loaded into the port, stepped once, and every leaf of state t+1 and of the
trace dict is held within 1e-6 of the leaf's largest value over the run
(``tests/torch_netsim_jax.py``; queue levels against at least
``QUEUE_SCALE`` bytes), integer leaves equal.
"""
import pytest

from repro.config.base import NetConfig as JNetConfig
from repro.netsim import topology as jtopo
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import topology as ptopo
from repro_torch.netsim import workload as pwork
from torch_netsim_jax import (
    jax_states, over_step_limits, port_step, worst_step_errors,
)
from torch_parity import (
    ALL_SCHEMES, LINKS3_H_US, MESH_H_US, PARTS, golden_workload, links3_config,
    mesh_config, mesh_workload,
)

SCENARIOS = {
    "links3": (lambda c, t: [links3_config(c)], lambda w: golden_workload("seq", w),
               LINKS3_H_US),
    "mesh": (lambda c, t: [mesh_config(c, t)], mesh_workload, MESH_H_US),
}


def _sampled(name, steps):
    """Every 13th step, the geopipe stage boundaries and slot boundaries of
    every 160 steps, and the steps around each recorded parting."""
    parts = {p + d for (n, _), (p, _) in PARTS.items() if n == name for d in (-1, 0)}
    ts = (set(range(0, steps, 13)) | set(range(39, steps, 160))
          | set(range(40, steps, 160)) | set(range(19, steps, 160)) | parts)
    return sorted(t for t in ts if t < steps - 1)


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_single_step_matches_jax(name, scheme):
    cfgs, wl, h = SCENARIOS[name]
    steps = int(h / 5.0)
    states, outs = jax_states(cfgs(JNetConfig, jtopo), wl(jwork), scheme, steps)
    step = port_step(cfgs(NetConfig, ptopo), wl(pwork), scheme)
    worst = worst_step_errors(states, outs, step, _sampled(name, steps))
    assert any(k.startswith("out.link_tx") for k in worst), sorted(worst)
    assert len(worst) > 40, sorted(worst)
    bad = over_step_limits(worst)
    assert not bad, f"leaves over the limit (error, step): {bad}"
