"""Budget-gated pseudo-ACK generation at the source OTN (Fig. 2(c)/(d)).

The source OTN tracks per connection the bytes it accepted from the sender
and the bytes it pseudo-ACKed back. Credits accrue at the flow's budget
share; each step it releases ``min(accepted - packed, credits)``, so the
sender's window advances at source-local latency but never faster than the
destination-sustainable budget. The ungated variant (credits = inf) is the
NTT pseudo-ACK baseline.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.netsim.soft import clip


class PseudoAckState(NamedTuple):
    packed: torch.Tensor     # [..., F] bytes pseudo-ACKed so far
    credits: torch.Tensor    # [..., F] byte credits (token bucket)


def init_pseudo_ack(num_flows: int, batch_shape=(), device=None) -> PseudoAckState:
    z = torch.zeros(*batch_shape, num_flows, device=device)
    return PseudoAckState(packed=z, credits=z.clone())


def step_pseudo_ack(state: PseudoAckState, accepted: torch.Tensor,
                    budget_share: torch.Tensor, dt_s: float, gated: bool,
                    max_burst_s: float = 2e-3):
    """One step. ``accepted``: cumulative bytes accepted at the source OTN;
    ``budget_share``: bytes/s. Returns (new_state, pseudo_acked_cum).
    Credits are capped at ``max_burst_s`` of budget."""
    backlog = clip(accepted - state.packed, 0.0)
    if gated:
        credits = torch.minimum(state.credits + budget_share * dt_s,
                                budget_share * max_burst_s)
        release = torch.minimum(backlog, credits)
        credits = credits - release
    else:
        credits = state.credits
        release = backlog
    packed = state.packed + release
    return PseudoAckState(packed=packed, credits=credits), packed
