"""The port's soft step converges to its hard step as the temperature drops
(tests/test_soft_convergence.py's property, the port alone), and its soft
rows equal the JAX package's, for the seven schemes: at 96 km, 6 ms, throughput_workload(8e6, 4,
num_flows=4), the soft temperatures (0.5, 0.2, 0.05) as one batch (the
temperature is a per-scenario leaf) against a hard run:

  * the coldest temperature's throughput within 5% of the hard run's, and no
    worse than the warmest's by more than 0.02;
  * the soft rows at 0.5 against JAX's (``run_experiment_batch`` of the
    same batch) within the row tolerances of the hard runner tests
    (``torch_parity.assert_rows_close``, metrics mode).
"""
import pytest

from repro.config.base import NetConfig as JNetConfig
from repro.netsim import get_scheme as jget
from repro.netsim import run_experiment_batch as jrun
from repro.netsim.workload import throughput_workload as jthroughput
from repro_torch.config.net import NetConfig
from repro_torch.netsim import run_experiment_batch
from repro_torch.netsim.workload import throughput_workload
from torch_parity import ALL_SCHEMES, assert_rows_close

TEMPS = (0.5, 0.2, 0.05)
HORIZON = 6_000.0


def _convergence(scheme):
    """The relative throughput errors of the soft rows at TEMPS against the
    hard row, after holding the 0.5 row to JAX's."""
    wl = throughput_workload(8e6, 4, num_flows=4)
    hard = run_experiment_batch([NetConfig(distance_km=96.0, horizon_us=HORIZON)],
                                wl, scheme, HORIZON, trace_mode="metrics",
                                device="cpu")[0]
    soft = run_experiment_batch(
        [NetConfig(distance_km=96.0, horizon_us=HORIZON, soft_step=True, soft_temp=t)
         for t in TEMPS], wl, scheme, HORIZON, trace_mode="metrics", device="cpu")
    jsoft = jrun([JNetConfig(distance_km=96.0, horizon_us=HORIZON, soft_step=True,
                             soft_temp=TEMPS[0])],
                 jthroughput(8e6, 4, num_flows=4), jget(scheme), HORIZON,
                 trace_mode="metrics")
    assert_rows_close(soft[:1], jsoft, metrics_mode=True, what=f"soft {scheme}")
    ref = max(abs(hard["throughput_gbps"]), 1e-6)
    return [abs(r["throughput_gbps"] - hard["throughput_gbps"]) / ref for r in soft]


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_soft_converges_to_hard_and_matches_jax(scheme):
    errs = _convergence(scheme)
    assert errs[-1] < 0.05, (scheme, errs)
    assert errs[-1] <= errs[0] + 0.02, (scheme, errs)
