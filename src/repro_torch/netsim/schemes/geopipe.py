"""GeoPipe-style lossless source-OTN pipeline shaping (arXiv:2510.12064).

Instead of letting long-haul PFC storms form, the source OTN paces its
release so the destination segment is never overrun, and schedules the
release of pipeline-stage traffic so stage bursts do not collide:

  * ``src_otn_release`` - PFC-free pacing gated on a credit window: at most
    ``geopipe_credit_bdp_frac`` x 2D.C bytes outstanding toward the
    destination (released minus the grants returned over the control
    channel, one-way delay D). Grants advertise the destination's
    cumulative egress plus its remaining buffer headroom. The stage whose
    slice is current drains with weight ``stage_boost`` (flow i belongs to
    stage ``i % num_stages``); a second pass hands what it cannot absorb to
    the rest of the backlog.
  * ``sender_rate`` - inter-DC flows are window-limited only; intra-DC
    flows keep DCQCN.
  * ``feedback`` - inter-DC CNPs are consumed at the destination OTN; the
    destination ships the grants on the control subchannel.

The hard paths of the JAX package's ``netsim/schemes/geopipe.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.config.net import NetParams
from repro_torch.core.budget import (
    ControlChannel, channel_send_recv, control_proc_steps_traced,
    init_channel,
)
from repro_torch.netsim.schemes.base import (
    Feedback, Scheme, SchemeCtx, SchemeSignals, long_haul_bdp,
)


class GeoPipeState(NamedTuple):
    """Scheme-private state carried in ``SimState.extra`` (``[B]`` leaves)."""
    chan: ControlChannel         # DST -> SRC credit-grant channel
    granted_at_src: torch.Tensor  # delayed cumulative grant at the source
    egress_cum: torch.Tensor     # cumulative dst-OTN egress (dst side)
    stage_phase: torch.Tensor    # int32: the stage whose slice is current


class GeoPipeScheme(Scheme):
    """Credit-window pacing plus stage scheduling. ``num_stages``,
    ``stage_slice_us`` and ``stage_boost`` are static; the window is the
    per-scenario ``geopipe_credit_bdp_frac``."""

    def __init__(self, num_stages: int = 4, stage_slice_us: float = 200.0,
                 stage_boost: float = 4.0):
        self.num_stages = int(num_stages)
        self.stage_slice_us = float(stage_slice_us)
        self.stage_boost = float(stage_boost)
        super().__init__()

    def init_extra_state(self, cfg, params: NetParams, num_flows: int, *,
                         history_slots: int = 0, chan_delay_pad: int = 0):
        if params is None:
            params = NetParams.of(cfg)
        if chan_delay_pad <= 0:
            chan_delay_pad = cfg.static_delay_steps + cfg.control_proc_steps
        # the grant line starts at zero (cumulative egress); it wraps at each
        # scenario's delay plus processing steps, inside the padded ring
        chan = init_channel(
            chan_delay_pad, cfg, params=params,
            actual_delay=(params.delay_steps(cfg.dt_us)
                          + control_proc_steps_traced(cfg, params)),
            fill=0.0)
        z = torch.zeros_like(chan.line_budget[..., 0])
        return GeoPipeState(chan=chan, granted_at_src=z, egress_cum=z.clone(),
                            stage_phase=torch.zeros_like(chan.idx))

    def _credit(self, ctx: SchemeCtx, state):
        """(available credit bytes, window bytes) from the source's view;
        the bytes released are the inter-DC bytes sent minus those queued."""
        window = ctx.params.geopipe_credit_bdp_frac * long_haul_bdp(ctx)
        released = ((state.sent * ctx.is_inter).sum(-1)
                    - state.q_src.sum(-1))
        credit = torch.clamp(
            window - (released - state.extra.granted_at_src), min=0.0)
        return credit, window

    def sender_rate(self, ctx: SchemeCtx, state, base_rate):
        return torch.where(ctx.is_inter > 0, base_rate,
                           torch.minimum(state.cc.rc, base_rate))

    def src_otn_release(self, ctx: SchemeCtx, state, arrivals, cap, active):
        credit, _ = self._credit(ctx, state)
        cap = torch.minimum(cap, credit)         # PFC-free pacing: credit gate
        avail = state.q_src + arrivals
        f = avail.shape[-1]
        stage = torch.remainder(torch.arange(f, device=avail.device),
                                self.num_stages)
        boost = torch.where(stage == state.extra.stage_phase[..., None],
                            self.stage_boost, 1.0)
        w = avail * boost                        # stage-aware weighted drain
        tot_w = w.sum(-1, keepdim=True)
        drained_tot = torch.minimum(avail.sum(-1), cap)[..., None]
        share = torch.where(tot_w > 0, w / torch.clamp(tot_w, min=1e-12), 0.0)
        drained = torch.minimum(share * drained_tot, avail)
        # work-conserving second pass: what the boosted stage could not
        # absorb goes to the remaining backlog in proportion
        leftover = drained_tot - drained.sum(-1, keepdim=True)
        rem = avail - drained
        rem_tot = rem.sum(-1, keepdim=True)
        drained = drained + torch.where(
            rem_tot > 0, rem / torch.clamp(rem_tot, min=1e-12), 0.0) * leftover
        return avail - drained, drained

    def feedback(self, ctx: SchemeCtx, state, sig: SchemeSignals) -> Feedback:
        gp = state.extra
        # grants: drained bytes plus remaining destination headroom
        egress_cum = gp.egress_cum + sig.egress_bytes
        headroom = torch.clamp(ctx.xoff_otn - sig.q_dst_tot, min=0.0)
        chan, granted, _ = channel_send_recv(gp.chan, egress_cum + headroom,
                                             torch.zeros_like(egress_cum))
        # stage rotation for the next step's release schedule:
        # floor((t + 1) dt / slice), read as the JAX package's compiled step
        # reads it, one multiply by the f32 constant dt * (1 / slice) (so
        # (t + 1) dt = 4800 us gives 23.999998 slices of 200 us, and each
        # stage boundary falls on the step after the exact one)
        per_step = float(np.float32(ctx.dt_us)
                         * np.float32(1.0 / self.stage_slice_us))
        slices = (sig.t.to(torch.float32) + 1.0) * per_step
        phase = torch.remainder(torch.floor(slices).to(torch.int32),
                                self.num_stages)
        return Feedback(
            cnp_wire=torch.zeros_like(sig.cnp_out),
            cnp_in=sig.cnp_out * ctx.is_intra,
            proxy_timer=state.proxy_timer,
            proxy_mod=state.proxy_mod,
            extra=gp._replace(chan=chan, granted_at_src=granted,
                              egress_cum=egress_cum,
                              stage_phase=phase.expand_as(gp.stage_phase)),
        )

    def extra_traces(self, ctx: SchemeCtx, state) -> dict:
        credit, _ = self._credit(ctx, state)
        stall = ((credit <= 1.0)
                 & (state.q_src.sum(-1) > 1.0)).to(torch.float32)
        return {"credit_bytes": credit, "credit_stall": stall}

    def init_metric_acc(self, ctx: SchemeCtx, state) -> dict:
        z = torch.zeros_like(state.extra.egress_cum)
        return {"credit_sum": z, "credit_stall_sum": z.clone()}

    def accumulate_metrics(self, ctx: SchemeCtx, acc, state, out, inc):
        return dict(acc,
                    credit_sum=acc["credit_sum"] + out["credit_bytes"] * inc,
                    credit_stall_sum=acc["credit_stall_sum"]
                    + out["credit_stall"] * inc)

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int) -> dict:
        return {
            "mean_credit_mb":
                np.asarray(acc["credit_sum"]) / max(n_warm, 1) / 1e6,
            "credit_stall_frac":
                np.asarray(acc["credit_stall_sum"]) / max(n_warm, 1),
        }
