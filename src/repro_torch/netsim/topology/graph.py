"""Site-graph topology: N sites compiled onto the ``[L]`` link axis.

A :class:`SiteGraph` declares a geo-distributed deployment as a small
directed multigraph: ``num_sites`` datacenters and one :class:`SiteEdge`
per long-haul OTN link, each edge with its own delay, capacity and PFC
threshold. ``compile_site_graph`` lowers it onto the engine's per-link
machinery: each edge becomes one entry of the ``num_paths`` link axis, its
attributes the ``path_delay_scale`` / ``path_cap_frac`` / ``path_thresh_kb``
tuples, and its (src, dst) pair lands in ``NetConfig.site_edges``.

Flows name their endpoints with ``FlowSpec(src_site=..., dst_site=...)``;
in the step the engine masks each flow's routing row down to the edges of
its site pair. Host-side Python and numpy only: the port's copy of the JAX
package's ``netsim/topology/graph.py`` (``docs/sites.md``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "SiteEdge",
    "SiteGraph",
    "compile_site_graph",
    "validate_site_endpoints",
]


@dataclass(frozen=True)
class SiteEdge:
    """One directed long-haul link between two sites.

    Attributes map 1:1 onto the per-link knobs of ``docs/topology.md``:
    ``delay_scale`` multiplies ``NetConfig.one_way_delay_us``;
    ``cap_frac`` is this link's fraction of ``otn_capacity_gbps``
    (``None`` = an equal split over all edges); ``thresh_kb`` overrides
    the per-link dst-OTN PFC threshold (``None`` = ``pfc_xoff_kb``).
    """

    src: int
    dst: int
    delay_scale: float = 1.0
    cap_frac: Optional[float] = None
    thresh_kb: Optional[float] = None


@dataclass(frozen=True)
class SiteGraph:
    """``num_sites`` datacenters + one :class:`SiteEdge` per OTN link.

    Parallel edges between the same site pair are allowed (they model a
    link bundle on that pair). The graph validates eagerly, so a bad mesh
    fails at construction, not inside a run.
    """

    num_sites: int
    edges: tuple

    def __post_init__(self):
        if self.num_sites < 2:
            raise ValueError(
                f"SiteGraph: num_sites must be >= 2, got {self.num_sites}")
        if not self.edges:
            raise ValueError("SiteGraph: at least one edge is required")
        for e in self.edges:
            if not isinstance(e, SiteEdge):
                raise TypeError(
                    f"SiteGraph: edges must be SiteEdge instances, got "
                    f"{type(e).__name__}")
            if not (0 <= e.src < self.num_sites
                    and 0 <= e.dst < self.num_sites):
                raise ValueError(
                    f"SiteGraph: edge ({e.src}, {e.dst}) references a site "
                    f"outside [0, {self.num_sites})")
            if e.src == e.dst:
                raise ValueError(
                    f"SiteGraph: self-edge at site {e.src} — a link must "
                    f"connect two distinct sites")

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def site_pairs(self) -> tuple:
        """The (src, dst) pair of every edge, in link-axis order."""
        return tuple((e.src, e.dst) for e in self.edges)

    def edges_between(self, src: int, dst: int) -> tuple:
        """Link-axis indices of the edges serving the (src, dst) pair."""
        return tuple(i for i, e in enumerate(self.edges)
                     if (e.src, e.dst) == (src, dst))

    def to_net_config(self, base_cfg):
        """Lower the graph onto ``base_cfg``'s link axis.

        Returns a new ``NetConfig`` with ``num_paths = num_edges`` and the
        per-edge attributes written into the ``path_*`` knobs; everything
        else (delay, capacity, scheme knobs, channel model, ...) is
        inherited from ``base_cfg`` unchanged.
        """
        caps = [e.cap_frac for e in self.edges]
        if any(c is not None for c in caps):
            # mixed explicit/None rows: the unnamed edges split what the
            # named ones left on the table
            named = sum(c for c in caps if c is not None)
            unnamed = sum(1 for c in caps if c is None)
            rest = max(1.0 - named, 0.0) / unnamed if unnamed else 0.0
            cap_frac = tuple(rest if c is None else float(c) for c in caps)
        else:
            cap_frac = ()
        thr = [e.thresh_kb for e in self.edges]
        if any(t is not None for t in thr):
            fill = base_cfg.pfc_xoff_kb
            thresh_kb = tuple(fill if t is None else float(t) for t in thr)
        else:
            thresh_kb = ()
        return dataclasses.replace(
            base_cfg,
            num_sites=self.num_sites,
            num_paths=self.num_edges,
            site_edges=self.site_pairs(),
            path_delay_scale=tuple(float(e.delay_scale)
                                   for e in self.edges),
            path_cap_frac=cap_frac,
            path_thresh_kb=thresh_kb,
        )


def compile_site_graph(graph: SiteGraph, base_cfg):
    """Functional alias of :meth:`SiteGraph.to_net_config`."""
    return graph.to_net_config(base_cfg)


def validate_site_endpoints(cfg, wlp) -> None:
    """Host-side pre-flight: every active inter-DC flow must have at
    least one edge serving its (src_site, dst_site) pair.

    A flow whose endpoints match no edge would see an all-zero routing
    row — its bytes spill back into the source queue forever and the run
    silently stalls. Raise before the run instead. Accepts [F] or stacked
    [B, F] ``WorkloadParams`` leaves (concrete arrays only — callers
    invoke this before the run).
    """
    pairs = set(cfg.edge_pairs())
    src = np.asarray(wlp.src_site).reshape(-1)
    dst = np.asarray(wlp.dst_site).reshape(-1)
    inter = np.asarray(wlp.is_inter).reshape(-1)
    active = np.asarray(wlp.active_mask).reshape(-1)
    bad = set()
    for s, d, it, ac in zip(src, dst, inter, active):
        if it > 0 and ac > 0 and (int(s), int(d)) not in pairs:
            bad.add((int(s), int(d)))
    if bad:
        shown = ", ".join(f"{s} -> {d}" for s, d in sorted(bad))
        raise ValueError(
            f"validate_site_endpoints: inter-DC flow endpoints {shown} "
            f"match no edge of the site graph "
            f"(edges: {sorted(pairs)}) — such a flow would stall forever; "
            f"add an edge for the pair or fix the FlowSpec "
            f"src_site/dst_site")
