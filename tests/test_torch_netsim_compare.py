"""The seven-scheme figures of ``python -m repro_torch.launch.netsim``
(``--figure scheme_compare`` and ``--figure topology``) against
``benchmarks/scheme_compare.py``: the same cells, workload and asserted
columns, and each scheme's streamed rows against the JAX package's
``sweep_grid`` on the same grid (``assert_rows_close`` in ``metrics`` mode:
the Fig. 3 columns within 1e-3, the schemes' own columns within 1e-3 but for
``ROW_PARTS``). Both run with the horizon cut to ``CUT_US`` (the workload's
burst scales with it, as scheme_compare's does), so that the port's CPU path
fits a test; the full grids run on the card (``chip_smoke.py`` phase 11).

A cell whose runs part at a recorded threshold (``PARTS``, e.g. the
source-OTN PFC at 50 km for dcqcn) differs by one flow-step of bytes, 3e-3
of a 600-step row: it is held instead by its full traces before the parting
step, and by the threshold itself, crossed at that step in one run only.
"""
import numpy as np
import pytest
import torch

import repro.netsim as jnetsim
from benchmarks import scheme_compare as sc
from repro.config.base import NetConfig as JNetConfig
from repro_torch.config.net import NetConfig
from repro_torch.launch import netsim as launch
from repro_torch.netsim import ALL_SCHEMES
from repro_torch.netsim import fluid as pfl
from torch_parity import (
    PARTS, QUEUE_SCALE, assert_rows_close, assert_traces_close_before,
)

CUT_US = 3_000.0


class _Keep(launch.Figure):
    """A figure that keeps each scheme's rows and configs."""

    def __init__(self):
        super().__init__("test", launch.resolve_device("cpu"), CUT_US, 0)
        self.rows, self.cfgs = {}, None

    def run(self, cfgs, workload, scheme, horizon_us, trace_mode="full"):
        rows, us = super().run(cfgs, workload, scheme, horizon_us, trace_mode)
        self.rows[scheme], self.cfgs = rows, cfgs
        return rows, us


def test_asserted_columns_are_scheme_compare_s():
    assert launch.STREAMED_COLS == sc.STREAMED_COLS
    assert launch.TOPOLOGY_COLS == sc.TOPOLOGY_COLS
    assert tuple(ALL_SCHEMES) == tuple(sc.ALL_SCHEMES)


@pytest.mark.parametrize("figure", ["scheme_compare", "topology"])
def test_figure_rows_match_jax(figure):
    fig = _Keep()
    printed = launch.FIGURES[figure](fig, full=False)
    jcfgs = [JNetConfig(**{f: getattr(c, f) for f in (
        "distance_km", "num_paths", "path_delay_scale", "path_cap_frac")})
        for c in fig.cfgs]
    assert len(jcfgs) == (7 if figure == "scheme_compare" else 9)
    jrows = jnetsim.sweep_grid(jcfgs, sc._workload(CUT_US), sc.ALL_SCHEMES, CUT_US,
                               trace_mode="metrics")
    for i, s in enumerate(ALL_SCHEMES):
        prows, srows = fig.rows[s], jrows[i::len(ALL_SCHEMES)]
        parted = [c for c, r in enumerate(prows)
                  if (f"compare_{r['distance_km']:g}km", s) in PARTS
                  and figure == "scheme_compare"]
        for c in parted:
            _assert_parts_at_threshold(prows[c]["distance_km"], s)
        keep = [c for c in range(len(prows)) if c not in parted]
        assert_rows_close([prows[c] for c in keep], [srows[c] for c in keep],
                          True, f"{figure} {s}")
    assert len(printed) == len(jcfgs) * 7 + 7


def _assert_parts_at_threshold(distance_km, scheme):
    """The cell's full traces within TRACE_REL before the recorded step, and
    sum(q_src) on either side of xoff_otn in the two runs just before it."""
    part, _ = PARTS[(f"compare_{distance_km:g}km", scheme)]
    wl_j = sc._workload(CUT_US)
    _, jt = jnetsim.simulate_batch([JNetConfig(distance_km=distance_km)], wl_j,
                                   jnetsim.get_scheme(scheme), CUT_US)
    _, pt = pfl.simulate_batch([NetConfig(distance_km=distance_km)],
                               launch.compare_workload(CUT_US), scheme, CUT_US,
                               device="cpu")
    jt = {k: np.asarray(v) for k, v in jt.items()}
    pt = {k: v.numpy() for k, v in pt.items()}
    assert_traces_close_before(pt, jt, part, f"{distance_km} km {scheme}",
                               floors={"q_src": QUEUE_SCALE, "q_dst": QUEUE_SCALE,
                                       "q_leaf": QUEUE_SCALE})
    xoff_otn = 0.1 * (NetConfig().otn_capacity_gbps * 1e9 / 8.0) * 2.0 \
        * NetConfig(distance_km=distance_km).one_way_delay_us * 1e-6
    a, b = jt["q_src"][0, part - 1], pt["q_src"][0, part - 1]
    assert (a > xoff_otn) != (b > xoff_otn), (a, b, xoff_otn)


def test_every_scheme_compare_grid_is_a_figure():
    """scheme_compare.py's five grids are launch.netsim figures (the channel,
    sites and failover ones held in tests/test_torch_netsim_channel_figures.py);
    without a GPU the model substrate still refuses to build by default."""
    assert {"scheme_compare", "topology", "impairment", "sites",
            "failover"} <= set(launch.FIGURES)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    from repro_torch.config import get_model_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_model_config("qwen1.5-0.5b", smoke=True))
