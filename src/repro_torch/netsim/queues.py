"""Queue helpers for the fluid simulator: ECN marking, PFC hysteresis,
proportional-fair fluid drains (the hard paths of the JAX package's
``netsim/queues.py``).

Shape-agnostic: per-flow tensors are ``[..., F]`` and per-scenario scalars
``[...]`` (0-d for one scenario, ``[B]`` for a batch).
"""
from __future__ import annotations

import torch


def ecn_mark_prob(q_bytes: torch.Tensor, cfg, params=None) -> torch.Tensor:
    """DCQCN RED-like marking probability from queue occupancy. ``params``
    (a ``NetParams``) supplies the per-scenario thresholds when batching."""
    src = cfg if params is None else params
    kmin = src.ecn_kmin_kb * 1024.0
    kmax = src.ecn_kmax_kb * 1024.0
    frac = torch.clamp((q_bytes - kmin) / torch.clamp(kmax - kmin, min=1.0),
                       0.0, 1.0)
    over = (q_bytes > kmax).to(torch.float32)
    return frac * cfg.ecn_pmax + over * (1.0 - cfg.ecn_pmax)


def pfc_hysteresis(paused: torch.Tensor, q_bytes: torch.Tensor,
                   xoff_bytes, xon_bytes) -> torch.Tensor:
    """XOFF above ``xoff``, XON below ``xon``, hold in between."""
    return torch.where(q_bytes > xoff_bytes, 1.0,
                       torch.where(q_bytes < xon_bytes, 0.0, paused))


def drain_proportional(q: torch.Tensor, arrivals: torch.Tensor,
                       capacity_bytes: torch.Tensor):
    """Fluid FIFO-fair drain: remove up to ``capacity_bytes`` from the queue,
    split across flows proportionally to their backlog (+ fresh arrivals).

    q, arrivals: ``[..., F]`` per-flow bytes; capacity ``[...]``. Returns
    (new_q, drained), both ``[..., F]``.
    """
    avail = q + arrivals
    tot = avail.sum(-1)
    drained_tot = torch.minimum(tot, capacity_bytes)
    tot = tot[..., None]
    share = torch.where(tot > 0, avail / torch.clamp(tot, min=1e-12), 0.0)
    drained = share * drained_tot[..., None]
    return avail - drained, drained
