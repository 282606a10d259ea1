"""Multi-site topology: ``SiteGraph`` + ``SiteEdge`` declare an N-site mesh,
``compile_site_graph`` lowers it onto the ``[L]`` link axis, and
``validate_site_endpoints`` is the host-side check the simulate entry points
run on multi-site configs."""
from repro_torch.netsim.topology.graph import (
    SiteEdge, SiteGraph, compile_site_graph, validate_site_endpoints,
)

__all__ = ["SiteEdge", "SiteGraph", "compile_site_graph",
           "validate_site_endpoints"]
