"""Registry-backed scheme package: the paper's four schemes and the plug-in
API. ``geopipe``, ``sdr_rdma`` and ``rdmacell`` raise ``NotImplementedError``
by name until the slice that ports them."""
from repro_torch.netsim.schemes.base import (
    Feedback, Scheme, SchemeCtx, SchemeLike, SchemeSignals,
    available_schemes, get_scheme, long_haul_bdp, register_scheme,
    unregister_scheme,
)
from repro_torch.netsim.schemes.dcqcn import DcqcnScheme, ThemisScheme
from repro_torch.netsim.schemes.matchrdma import MatchRdmaScheme
from repro_torch.netsim.schemes.pseudo_ack import PseudoAckScheme

register_scheme("dcqcn", DcqcnScheme)
register_scheme("pseudo_ack", PseudoAckScheme)
register_scheme("themis", ThemisScheme)
register_scheme("matchrdma", MatchRdmaScheme)

# The paper's four schemes (Fig. 3).
SCHEMES = ("dcqcn", "pseudo_ack", "themis", "matchrdma")

__all__ = [
    "Feedback", "SCHEMES", "Scheme", "SchemeCtx", "SchemeLike",
    "SchemeSignals", "DcqcnScheme", "MatchRdmaScheme", "PseudoAckScheme",
    "ThemisScheme", "available_schemes", "get_scheme", "long_haul_bdp",
    "register_scheme", "unregister_scheme",
]
