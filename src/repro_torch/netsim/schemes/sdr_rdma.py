"""SDR-RDMA-style software-defined reliability (arXiv:2505.05366).

A selective-repeat reliability layer over end-to-end DCQCN, with three
per-scenario knobs:

  ``sdr_window_bdp_frac``   receive window as a fraction of the long-haul
                            BDP (2D.C): the un-acked bytes a sender may hold.
  ``sdr_ack_coalesce_us``   ACK-coalescing interval: the sender's window view
                            only advances at coalescing boundaries.
  ``sdr_retx_budget_frac``  NIC rate share reserved for repair, engaged in
                            proportion to an EWMA of degradation (CNP
                            arrivals, and loss notifications on a lossy
                            channel).

``ack_view`` exposes the coalesced snapshot, ``sender_rate`` applies the
window cap and the repair reservation, ``feedback`` advances the ACK ledger,
the coalescing timer and the EWMA, and ``retx_rate`` grants repair the
reserved budget on top of the congestion-controlled rate. The hard paths of
the JAX package's ``netsim/schemes/sdr_rdma.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.netsim.schemes.base import (
    Feedback, Scheme, SchemeCtx, SchemeSignals, long_haul_bdp,
)

# the repair-budget reservation can never starve new data entirely
MAX_RETX_FRAC = 0.9


class SdrRdmaState(NamedTuple):
    """Scheme-private state carried in ``SimState.extra``."""
    ack_cum: torch.Tensor         # [B, F] true cumulative acked bytes
    ack_held: torch.Tensor        # [B, F] coalesced snapshot the sender sees
    coalesce_timer: torch.Tensor  # [B] us since the last ACK release
    cong_ewma: torch.Tensor       # [B] in [0, 1], the degradation EWMA


class SdrRdmaScheme(Scheme):
    """Software-defined selective-repeat reliability over e2e DCQCN."""

    def init_extra_state(self, cfg, params, num_flows: int, *,
                         history_slots: int = 0, chan_delay_pad: int = 0):
        ref = params.one_way_delay_us
        z = torch.zeros(*ref.shape, num_flows, device=ref.device)
        return SdrRdmaState(ack_cum=z, ack_held=z.clone(),
                            coalesce_timer=torch.full_like(ref, 1e9),
                            cong_ewma=torch.zeros_like(ref))

    def _retx_frac(self, ctx: SchemeCtx, state):
        """Repair-budget rate share currently engaged, ``[B]``."""
        return (torch.clamp(ctx.params.sdr_retx_budget_frac, 0.0,
                            MAX_RETX_FRAC) * state.extra.cong_ewma)

    def ack_view(self, ctx: SchemeCtx, state, ack_arr):
        return state.extra.ack_held

    def sender_rate(self, ctx: SchemeCtx, state, base_rate):
        swnd = ctx.params.sdr_window_bdp_frac * long_haul_bdp(ctx)
        unacked = state.sent - torch.minimum(state.extra.ack_held, state.sent)
        sr_avail = torch.clamp(swnd[..., None] - unacked, min=0.0)
        rate = torch.minimum(state.cc.rc, base_rate)      # e2e DCQCN kept
        eff = (torch.minimum(rate, sr_avail / ctx.dt_s)
               * (1.0 - self._retx_frac(ctx, state))[..., None])
        return torch.where(ctx.is_inter > 0, eff, rate)

    def retx_rate(self, ctx: SchemeCtx, state, rate):
        """Repair gets the engaged reservation (a NIC-rate slice DCQCN does
        not squeeze) on top of the shared-rate default."""
        return (super().retx_rate(ctx, state, rate)
                + (self._retx_frac(ctx, state) * ctx.nic)[..., None])

    def feedback(self, ctx: SchemeCtx, state, sig: SchemeSignals) -> Feedback:
        sd = state.extra
        # the ACK-line row the skeleton read this step: the skeleton writes
        # it only after this hook, so each ACK batch is read once
        row = torch.remainder(sig.t, ctx.d_steps).to(torch.int64)
        ack_arr = state.ack_line.gather(
            -2, row[..., None, None].expand(*row.shape, 1,
                                            state.ack_line.shape[-1]))[..., 0, :]
        ack_cum = sd.ack_cum + ack_arr * ctx.is_inter
        timer = sd.coalesce_timer + ctx.dt_us
        fire = timer >= ctx.params.sdr_ack_coalesce_us
        held = torch.where(fire[..., None], ack_cum, sd.ack_held)
        timer = torch.where(fire, 0.0, timer)
        # degradation EWMA (~1 ms) engaging the repair budget: CNP arrivals
        # or loss notifications (zeros on the ideal channel)
        hit = (((sig.cnp_arr * ctx.is_inter).sum(-1) > 0)
               | ((sig.retx_arr * ctx.is_inter).sum(-1) > 0)).to(torch.float32)
        g = min(ctx.dt_us / 1000.0, 1.0)
        cong = (1.0 - g) * sd.cong_ewma + g * hit
        base = super().feedback(ctx, state, sig)           # e2e CNP routing
        return base._replace(extra=SdrRdmaState(
            ack_cum=ack_cum, ack_held=held, coalesce_timer=timer,
            cong_ewma=cong))

    def extra_traces(self, ctx: SchemeCtx, state) -> dict:
        sd = state.extra
        lag = (torch.clamp(sd.ack_cum - sd.ack_held, min=0.0)
               * ctx.is_inter).sum(-1)
        return {"sr_ack_lag": lag, "sr_retx_frac": self._retx_frac(ctx, state)}

    def init_metric_acc(self, ctx: SchemeCtx, state) -> dict:
        z = torch.zeros_like(state.extra.cong_ewma)
        return {"ack_lag_sum": z, "retx_frac_sum": z.clone()}

    def accumulate_metrics(self, ctx: SchemeCtx, acc, state, out, inc):
        return dict(acc,
                    ack_lag_sum=acc["ack_lag_sum"] + out["sr_ack_lag"] * inc,
                    retx_frac_sum=acc["retx_frac_sum"]
                    + out["sr_retx_frac"] * inc)

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int) -> dict:
        return {
            "mean_ack_lag_mb":
                np.asarray(acc["ack_lag_sum"]) / max(n_warm, 1) / 1e6,
            "mean_retx_reserve_frac":
                np.asarray(acc["retx_frac_sum"]) / max(n_warm, 1),
        }
