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
from repro_torch.netsim.soft import (
    clip, lerp, reset_gate, soft_gt, soft_or, soft_pos,
)

# soft-gate byte scale of loss-notification presence
_MTU = 1500.0


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

    def emit_events(self, ctx: SchemeCtx, prev_state, state, out) -> tuple:
        # the proxy brake fired iff some flow's brake timer was reset this
        # step (it otherwise only grows by dt_us); value = the deepest
        # post-brake modulation level
        fired = (state.proxy_timer < prev_state.proxy_timer).any(-1)
        return (("scheme_brake", 0, state.proxy_mod.amin(-1), fired),)

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
        scale = clip(cap / clip(want.sum(-1), 1e-9), hi=1.0)
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
        cut = clip(state.proxy_mod * 0.7, 0.25)
        recover = clip(state.proxy_mod * (1.0 + 5e-4 * ctx.dt_us), hi=1.0)
        if ctx.soft is None:
            fire = (((mr.summary_at_src > 0.5)[..., None] | (sig.retx_arr > 0))
                    & (proxy_timer >= cfg.cnp_interval_us))
            proxy_mod = torch.where(fire, cut, recover)
            proxy_timer = torch.where(fire, 0.0, proxy_timer)
        else:
            # the delayed summary is itself a soft weight (gate at the 0.5
            # midpoint); loss notifications gate through soft_pos (exactly
            # 0 with no loss); the timer's own reset takes the detached gate
            w_fire = (soft_or(soft_gt(mr.summary_at_src, 0.5, ctx.soft,
                                      0.25)[..., None],
                              soft_pos(sig.retx_arr, ctx.soft, _MTU))
                      * soft_gt(proxy_timer, cfg.cnp_interval_us, ctx.soft,
                                ctx.dt_us))
            proxy_mod = lerp(w_fire, cut, recover)
            proxy_timer = lerp(reset_gate(w_fire), 0.0, proxy_timer)

        # ---- destination loop: slot accumulation, boundary update, channel
        leaf_delay_us = (sig.q_leaf.sum(-1) / ctx.c_leaf * 1e6
                         + cfg.intra_dc_delay_us)
        mr = accumulate_step(
            mr, sig.egress_bytes, (sig.cnp_out * ctx.is_inter).sum(-1),
            leaf_delay_us, 1.0, sig.q_dst_tot, egress_paused=sig.leaf_pfc)
        mr = maybe_slot_update(mr, cfg, sig.t, ctx.period_slots,
                               params=ctx.params, soft=ctx.soft,
                               host_t=sig.host_t, slot_steps=ctx.slot_steps)
        if ctx.soft is None:
            overrun = (sig.q_dst_tot > 0.5 * ctx.xoff_otn).to(torch.float32)
        else:
            overrun = soft_gt(sig.q_dst_tot, 0.5 * ctx.xoff_otn, ctx.soft,
                              0.05 * ctx.xoff_otn + 1.0)
        mr = step_channel(mr, overrun, inplace=ctx.soft is None)

        return Feedback(
            # CNPs are consumed at the destination OTN: the long return wire
            # carries nothing, and the sender CC only hears intra-DC
            cnp_wire=torch.zeros_like(sig.cnp_out),
            cnp_in=sig.cnp_out * ctx.is_intra,
            proxy_timer=proxy_timer,
            proxy_mod=proxy_mod,
            extra=mr,
        )
