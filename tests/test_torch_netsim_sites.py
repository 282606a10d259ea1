"""The port's multi-site topology (``netsim/topology``: a site graph compiled
onto the ``[L]`` link axis, the per-flow endpoint matrix, the host-side
endpoint check) against the JAX package: the ideal-channel cases of
``tests/test_sites.py`` on the port, the same errors as JAX, and the seven
schemes' ``full`` traces on the 3-site mesh of
``benchmarks/scheme_compare.py`` (``SITES_EDGES``: two parallel 0->1 edges,
the second 1.5x longer, and a relay 0->2->1 at 0.2 of the capacity each,
100 km; ``_sites_workload`` on all three site pairs, 6 ms) against a live
JAX run, held as ``tests/test_torch_netsim_topology.py`` holds its cell.
"""
import numpy as np
import pytest

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import topology as jtopo
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import topology as ptopo
from repro_torch.netsim import workload as pwork
from torch_parity import (
    ALL_SCHEMES, COLUMN_FLOORS, MESH_H_US, PARTS, QUEUE_SCALE,
    assert_columns_close, assert_final_close, assert_traces_close_before,
    fig3_columns, leaves, mesh_config, mesh_workload,
)

H_US = 2_000.0
FLOORS = {k: QUEUE_SCALE for k in ("q_src", "q_dst", "q_leaf", "q_dst_link")}


def _wl(work, *pairs, route=()):
    return work.Workload(tuple(work.FlowSpec(True, 1 << 20, 16, route=route,
                                             src_site=s, dst_site=d)
                               for s, d in pairs))


def _run(cfgs, wl, scheme, h=H_US):
    return pfl.simulate_batch(cfgs, wl, scheme, h, device="cpu")


def _raised(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


def test_site_graph_compiles_as_jax():
    """The mesh lowers onto the same link axis, and bad graphs raise the same
    errors."""
    p, j = mesh_config(NetConfig, ptopo), mesh_config(JNetConfig, jtopo)
    for f in ("num_sites", "num_paths", "site_edges", "path_delay_scale",
              "path_cap_frac", "path_thresh_kb"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.edge_pairs() == j.edge_pairs() and p.is_multisite
    for bad in (dict(num_sites=1, edges=((0, 1),)), dict(num_sites=3, edges=()),
                dict(num_sites=3, edges=((1, 1),)), dict(num_sites=2, edges=((0, 2),)),
                dict(num_sites=2, edges=("x",))):
        def graph(topo):
            edges = tuple(topo.SiteEdge(*e) if isinstance(e, tuple) else e
                          for e in bad["edges"])
            return topo.SiteGraph(bad["num_sites"], edges)
        assert _raised(lambda: graph(ptopo)) == _raised(lambda: graph(jtopo))


@pytest.mark.parametrize("scheme", ("dcqcn", "matchrdma", "rdmacell"))
def test_two_site_edges_equal_plain_links(scheme):
    """Every edge spelled out as (0, 1) on two sites: the endpoint mask is all
    ones, and the run is the plain multi-link run bit for bit."""
    kw = dict(distance_km=100.0, num_paths=3, path_delay_scale=(1.0, 1.5, 2.0),
              path_cap_frac=(0.5, 0.3, 0.2))
    wl = pwork.throughput_workload(1 << 20, 16, 4)
    a = leaves(_run([NetConfig(**kw)], wl, scheme))
    b = leaves(_run([NetConfig(site_edges=((0, 1),) * 3, **kw)], wl, scheme))
    assert sorted(a) == sorted(b)
    assert not [k for k in a if not np.array_equal(a[k], b[k])]


def test_endpoint_matrix_masks_flows_onto_their_edges():
    """A relay-only workload leaves the direct links dark, a direct one the
    relay legs; one batch holds both (the endpoints are workload leaves)."""
    cfg = mesh_config(NetConfig, ptopo)
    _, tr = _run([cfg, cfg], [_wl(pwork, (0, 1), (0, 1)), _wl(pwork, (0, 2), (2, 1))],
                 "dcqcn")
    tx = tr["link_tx"].numpy()                                     # [B, T, L]
    assert tx[0, :, 2:].max() == 0.0 and tx[0, :, :2].sum() > 0.0
    assert tx[1, :, :2].max() == 0.0 and tx[1, :, 2].sum() > 0.0 and tx[1, :, 3].sum() > 0.0


def test_route_weights_bias_within_edge_set():
    """Route weights still split a flow within its own edge set: weighting
    the slow 0->1 edge to zero keeps everything on the fast one."""
    wl = _wl(pwork, *[(0, 1)] * 4, route=(1.0, 0.0, 1.0, 1.0))
    _, tr = _run([mesh_config(NetConfig, ptopo)], wl, "dcqcn")
    tx = tr["link_tx"].numpy()[0]
    assert tx[:, 0].sum() > 0.0 and tx[:, 1:].max() == 0.0


def test_multisite_conserves_and_completes():
    final, tr = _run([mesh_config(NetConfig, ptopo)], mesh_workload(pwork), "matchrdma")
    assert float(tr["cons_err"].max()) < 1e-3 and float(final.delivered.sum()) > 0


def test_unreachable_endpoints_raise_as_jax():
    """No edge serves 1 -> 0: the same ValueError before the run, from
    ``simulate``, ``simulate_batch`` and the checker itself."""
    jcfg, pcfg = mesh_config(JNetConfig, jtopo), mesh_config(NetConfig, ptopo)
    j = _raised(lambda: jnetsim.simulate_batch([jcfg], _wl(jwork, (1, 0)),
                                               jnetsim.get_scheme("dcqcn"), 100.0))
    p = _raised(lambda: pfl.simulate(pcfg, _wl(pwork, (1, 0)), "dcqcn", 100.0,
                                     device="cpu"))
    assert j == p and j[0] is ValueError and "1 -> 0" in j[1]
    assert _raised(lambda: ptopo.validate_site_endpoints(
        pcfg, pwork.WorkloadParams.of(_wl(pwork, (1, 0))))) == j
    ptopo.validate_site_endpoints(pcfg, pwork.WorkloadParams.of(_wl(pwork, (0, 2))))


def test_multisite_requires_link_axis_as_jax():
    j = _raised(lambda: jnetsim.simulate_batch(
        [JNetConfig(num_sites=3, num_paths=1, site_edges=((0, 2),))],
        _wl(jwork, (0, 2)), jnetsim.get_scheme("dcqcn"), 100.0))
    p = _raised(lambda: _run([NetConfig(num_sites=3, num_paths=1, site_edges=((0, 2),))],
                             _wl(pwork, (0, 2)), "dcqcn", 100.0))
    assert j[0] is p[0] is ValueError
    assert "requires num_paths > 1" in j[1] and "requires num_paths > 1" in p[1]


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_mesh_traces_match_jax(scheme):
    jf, jt = jnetsim.simulate_batch([mesh_config(JNetConfig, jtopo)],
                                    mesh_workload(jwork), jnetsim.get_scheme(scheme),
                                    MESH_H_US)
    pf, pt = _run([mesh_config(NetConfig, ptopo)], mesh_workload(pwork), scheme,
                  MESH_H_US)
    jt = {k: np.asarray(v) for k, v in jt.items()}
    pt = {k: v.numpy() for k, v in pt.items()}
    steps = jt["q_dst"].shape[1]
    assert sorted(pt) == sorted(jt) and pt["link_tx"].shape == (1, steps, 4)
    part, _ = PARTS.get(("mesh", scheme), (steps, None))
    what = f"mesh/{scheme}"
    assert_traces_close_before(pt, jt, part, what, floors=FLOORS)
    assert_columns_close(fig3_columns(pt, steps), fig3_columns(jt, steps), what,
                         COLUMN_FLOORS)
    assert_final_close(pf, jf, 5.0, what)
