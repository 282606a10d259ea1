"""The paper's scheme: segmented control + rate matching (Fig. 2).

  * ``ack_view``        - budget-gated pseudo-ACK: the sender's window spins
    at source-local latency but never faster than the destination budget.
  * ``sender_rate``     - inter-DC flows are not rate-limited by sender
    DCQCN (the source OTN shapes them); intra-DC flows keep the local loop.
  * ``src_otn_release`` - release <= budget share x proxy modulation.
  * ``feedback``        - CNPs are consumed at the destination OTN; the
    destination loop accumulates slot observations, runs the slot/budget
    update at slot boundaries, and ships (budget, congestion summary) on the
    control subchannel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.budget import fair_share
from repro_torch.core.matchrdma import (
    accumulate_step, maybe_slot_update, step_channel,
)
from repro_torch.core.pseudo_ack import step_pseudo_ack
from repro_torch.netsim.schemes.base import (
    Feedback, Scheme, SchemeCtx, SchemeSignals,
)


class MatchRdmaScheme(Scheme):
    """Segmented, rate-matched long-haul RDMA (the paper). Streams, beside
    the destination budget, the D-delayed budget the source enforced
    (``mean_budget_at_src_gbps``)."""

    def init_metric_acc(self, ctx: SchemeCtx, state) -> dict:
        return dict(super().init_metric_acc(ctx, state),
                    budget_at_src_sum=torch.zeros_like(state.extra.budget_at_src))

    def accumulate_metrics(self, ctx: SchemeCtx, acc, state, out, inc):
        acc = super().accumulate_metrics(ctx, acc, state, out, inc)
        return dict(acc, budget_at_src_sum=acc["budget_at_src_sum"]
                    + state.extra.budget_at_src * inc)

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int) -> dict:
        cols = super().finalize_metrics(acc, n_steps, n_warm)
        cols["mean_budget_at_src_gbps"] = (
            np.asarray(acc["budget_at_src_sum"]) / max(n_warm, 1) * 8.0 / 1e9)
        return cols

    def ack_view(self, ctx: SchemeCtx, state, ack_arr):
        return state.extra.pseudo.packed

    def sender_rate(self, ctx: SchemeCtx, state, base_rate):
        # inter-DC: window-limited only; intra-DC: conventional sender DCQCN
        return torch.where(ctx.is_inter > 0, base_rate,
                           torch.minimum(state.cc.rc, base_rate))

    def src_otn_release(self, ctx: SchemeCtx, state, arrivals, cap, active):
        # release <= budget share x proxy modulation: the budget is
        # authoritative, the proxy a fast bounded brake around it
        share = fair_share(state.extra.budget_at_src, active * ctx.is_inter)
        per_flow_cap = share * state.proxy_mod * ctx.dt_s
        avail = state.q_src + arrivals
        want = torch.minimum(avail, per_flow_cap * ctx.is_inter)
        scale = torch.clamp(cap / torch.clamp(want.sum(-1), min=1e-9), max=1.0)
        drained = want * scale[..., None]
        return avail - drained, drained

    def feedback(self, ctx: SchemeCtx, state, sig: SchemeSignals) -> Feedback:
        cfg = ctx.cfg
        # ---- source side: budget-gated pseudo-ACK release
        mr = state.extra
        share = fair_share(mr.budget_at_src, sig.active * ctx.is_inter)
        pseudo, _ = step_pseudo_ack(mr.pseudo, sig.sent * ctx.is_inter,
                                    share, ctx.dt_s, gated=True)
        mr = mr._replace(pseudo=pseudo)

        # ---- proxy brake from the delayed congestion summary, rate-limited:
        # cut x0.7 (floor 0.25), recover with a ~1 ms time constant. Loss
        # notifications (zeros without the repair path) brake the same way:
        # a dropping long haul is over-injection the budget estimator only
        # sees a control window later
        proxy_timer = state.proxy_timer + ctx.dt_us
        cut = torch.clamp(state.proxy_mod * 0.7, min=0.25)
        recover = torch.clamp(state.proxy_mod * (1.0 + 5e-4 * ctx.dt_us),
                              max=1.0)
        fire = (((mr.summary_at_src > 0.5)[..., None] | (sig.retx_arr > 0))
                & (proxy_timer >= cfg.cnp_interval_us))
        proxy_mod = torch.where(fire, cut, recover)
        proxy_timer = torch.where(fire, 0.0, proxy_timer)

        # ---- destination loop: slot accumulation, boundary update, channel
        leaf_delay_us = (sig.q_leaf.sum(-1) / ctx.c_leaf * 1e6
                         + cfg.intra_dc_delay_us)
        mr = accumulate_step(
            mr, sig.egress_bytes, (sig.cnp_out * ctx.is_inter).sum(-1),
            leaf_delay_us, 1.0, sig.q_dst_tot, egress_paused=sig.leaf_pfc)
        mr = maybe_slot_update(mr, cfg, sig.t, ctx.period_slots,
                               params=ctx.params)
        overrun = (sig.q_dst_tot > 0.5 * ctx.xoff_otn).to(torch.float32)
        mr = step_channel(mr, overrun)

        return Feedback(
            # CNPs are consumed at the destination OTN: the long return wire
            # carries nothing, and the sender CC only hears intra-DC
            cnp_wire=torch.zeros_like(sig.cnp_out),
            cnp_in=sig.cnp_out * ctx.is_intra,
            proxy_timer=proxy_timer,
            proxy_mod=proxy_mod,
            extra=mr,
        )
