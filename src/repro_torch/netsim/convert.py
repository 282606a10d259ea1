"""Carry the JAX package's netsim state into the port, and the port's out.

``state_from_numpy`` turns a JAX ``SimState`` whose leaves are numpy arrays
(``jax.tree.map(np.asarray, state)``) into the port's ``SimState``, leaf for
leaf, with the ``[B]`` axis where the batch has one (the ``[L]`` leaves of a
multi-link run, the extra state of every scheme and the channel slots
included: ``chan`` as the port's ``ImpairState``/``ReplayState`` or a dict,
the ``retx_*`` rings and backlog, each None where JAX's is);
``acc_from_numpy`` does the same for a ``MetricAcc`` (its dicts of ``[B]``
arrays become the port's key-ordered columns; the channel accumulator stays
a dict). Nothing here imports JAX: the objects are only read by field name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.budget import BudgetState, ControlChannel
from repro_torch.core.cc_proxy import DcqcnState
from repro_torch.core.matchrdma import MatchRdmaState
from repro_torch.core.pseudo_ack import PseudoAckState
from repro_torch.core.slots import SlotRing
from repro_torch.netsim.channel import ImpairState, ReplayState
from repro_torch.netsim.fluid import (
    STREAM_MAX_KEYS, STREAM_SUM_KEYS, MetricAcc, SimState,
)
from repro_torch.netsim.schemes import GeoPipeState, RdmaCellState, SdrRdmaState

_TYPES = {cls.__name__: cls for cls in (
    SimState, DcqcnState, MatchRdmaState, PseudoAckState, SlotRing,
    BudgetState, ControlChannel, GeoPipeState, SdrRdmaState, RdmaCellState,
    ImpairState, ReplayState)}


def _from(obj, device):
    if obj is None:
        return None
    fields = getattr(obj, "_fields", None)
    if fields is not None:
        cls = _TYPES[type(obj).__name__]
        return cls(*(_from(getattr(obj, f), device) for f in cls._fields))
    if isinstance(obj, dict):
        return {k: _from(v, device) for k, v in obj.items()}
    return torch.as_tensor(np.array(obj), device=device)


def state_from_numpy(state, device=None) -> SimState:
    """The port's ``SimState`` of a JAX ``SimState`` given as numpy arrays
    (or the port's twin of any state it holds, e.g. a ``MatchRdmaState``)."""
    return _from(state, device)


def acc_from_numpy(acc, device=None) -> MetricAcc:
    """The port's ``MetricAcc`` of a JAX ``MetricAcc`` given as numpy arrays."""
    def cols(d, keys):
        return torch.as_tensor(np.stack([np.asarray(d[k]) for k in keys], -1),
                               device=device)
    return MetricAcc(sum_s=cols(acc.sum_s, STREAM_SUM_KEYS),
                     sum_c=cols(acc.sum_c, STREAM_SUM_KEYS),
                     maxes=cols(acc.maxes, STREAM_MAX_KEYS),
                     hist=torch.as_tensor(np.array(acc.hist), device=device),
                     scheme=_from(acc.scheme, device),
                     chan=_from(acc.chan, device))


def to_numpy(tree):
    """Every tensor of a port pytree (NamedTuples, dicts) as numpy."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    return tree
