"""Ungated source-OTN pseudo-ACK (NTT GLOBECOM'24 baseline).

The source OTN acknowledges every byte it accepts at once, so the sender's
ACK-clocked window spins at source-local latency: distance-insensitive
throughput, but nothing matches the release rate to what the destination
can absorb, hence the buffer/pause blowups of Fig. 3(c,d). Congestion
control stays end-to-end.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.budget import fair_share
from repro_torch.core.pseudo_ack import step_pseudo_ack
from repro_torch.netsim.schemes.base import (
    Feedback, Scheme, SchemeCtx, SchemeSignals,
)


class PseudoAckScheme(Scheme):
    """Source-OTN pseudo-ACK, ungated; CC still e2e. Streams the pseudo-ACK
    lead (bytes acknowledged but not yet delivered) as
    ``mean_pseudo_lead_mb``."""

    gated = False

    def init_metric_acc(self, ctx: SchemeCtx, state) -> dict:
        return dict(super().init_metric_acc(ctx, state),
                    pseudo_lead_sum=torch.zeros_like(state.inflight[..., 0]))

    def accumulate_metrics(self, ctx: SchemeCtx, acc, state, out, inc):
        acc = super().accumulate_metrics(ctx, acc, state, out, inc)
        lead = (torch.clamp(state.extra.pseudo.packed - state.delivered, min=0.0)
                * ctx.is_inter).sum(-1)
        return dict(acc, pseudo_lead_sum=acc["pseudo_lead_sum"] + lead * inc)

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int) -> dict:
        cols = super().finalize_metrics(acc, n_steps, n_warm)
        cols["mean_pseudo_lead_mb"] = (np.asarray(acc["pseudo_lead_sum"])
                                       / max(n_warm, 1) / 1e6)
        return cols

    def ack_view(self, ctx: SchemeCtx, state, ack_arr):
        # the sender sees the source OTN's pseudo-ACK ledger, one step old
        return state.extra.pseudo.packed

    def feedback(self, ctx: SchemeCtx, state, sig: SchemeSignals) -> Feedback:
        mr = state.extra
        # the ungated ledger ignores the share: skip computing it
        share = (fair_share(mr.budget_at_src, sig.active * ctx.is_inter)
                 if self.gated else None)
        pseudo, _ = step_pseudo_ack(mr.pseudo, sig.sent * ctx.is_inter,
                                    share, ctx.dt_s, gated=self.gated)
        base = super().feedback(ctx, state, sig)
        return base._replace(extra=mr._replace(pseudo=pseudo))
