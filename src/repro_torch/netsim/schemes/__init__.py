"""Registry-backed scheme package: the paper's four schemes (``SCHEMES``),
the related-work pack (``RELATED_SCHEMES``: GeoPipe-style credit pacing,
SDR-RDMA-style software-defined reliability, RDMACell-style token-gated
spraying over the multi-link long haul) and the plug-in API.
``ALL_SCHEMES`` is their concatenation, in the JAX package's order."""
from repro_torch.netsim.schemes.base import (
    Feedback, Scheme, SchemeCtx, SchemeLike, SchemeSignals, apply_link_live,
    available_schemes, get_scheme, long_haul_bdp, register_scheme,
    unregister_scheme,
)
from repro_torch.netsim.schemes.dcqcn import DcqcnScheme, ThemisScheme
from repro_torch.netsim.schemes.geopipe import GeoPipeScheme, GeoPipeState
from repro_torch.netsim.schemes.matchrdma import MatchRdmaScheme
from repro_torch.netsim.schemes.pseudo_ack import PseudoAckScheme
from repro_torch.netsim.schemes.rdmacell import RdmaCellScheme, RdmaCellState
from repro_torch.netsim.schemes.sdr_rdma import SdrRdmaScheme, SdrRdmaState

register_scheme("dcqcn", DcqcnScheme)
register_scheme("pseudo_ack", PseudoAckScheme)
register_scheme("themis", ThemisScheme)
register_scheme("matchrdma", MatchRdmaScheme)
register_scheme("geopipe", GeoPipeScheme)
register_scheme("sdr_rdma", SdrRdmaScheme)
register_scheme("rdmacell", RdmaCellScheme)

# The paper's four schemes (Fig. 3) and the related-work pack.
SCHEMES = ("dcqcn", "pseudo_ack", "themis", "matchrdma")
RELATED_SCHEMES = ("geopipe", "sdr_rdma", "rdmacell")
ALL_SCHEMES = SCHEMES + RELATED_SCHEMES

__all__ = [
    "ALL_SCHEMES", "Feedback", "RELATED_SCHEMES", "SCHEMES", "Scheme",
    "SchemeCtx", "SchemeLike", "SchemeSignals", "DcqcnScheme",
    "GeoPipeScheme", "GeoPipeState", "MatchRdmaScheme", "PseudoAckScheme",
    "RdmaCellScheme", "RdmaCellState", "SdrRdmaScheme", "SdrRdmaState",
    "ThemisScheme", "apply_link_live", "available_schemes", "get_scheme",
    "long_haul_bdp", "register_scheme", "unregister_scheme",
]
