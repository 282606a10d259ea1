"""RDMACell-style token-gated flowcell spraying (arxiv 2606.20581).

Load-balances a long haul of parallel unequal links by spraying sub-flow
byte bursts across them in proportion to per-link token buckets, and paces
senders against the destination reorder buffer (ROB) the spraying creates:

  * ``route_weights`` - each flow's routing row reweighted by the per-link
    token level. Tokens refill with the link's capacity and drain with the
    bytes offered to it, so a slow or paused link runs dry and traffic moves
    away; when every bucket is dry the workload's own weights apply.
  * ``sender_rate`` - inter-DC senders are throttled together once the
    estimated ROB occupancy exceeds ``rdmacell_rob_limit_mb``.
  * ``feedback`` - advances the buckets and the cumulative per-link
    tx/arrival ledgers the ROB estimate is computed from.

Single-link runs (``num_paths == 1``) carry the default extra state and the
baseline hooks, so ``rdmacell`` at L = 1 is ``dcqcn`` bit for bit. The hard
paths of the JAX package's ``netsim/schemes/rdmacell.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.matchrdma import MatchRdmaState
from repro_torch.netsim.schemes.base import (
    Feedback, Scheme, SchemeCtx, SchemeSignals, apply_link_live,
)


class RdmaCellState(NamedTuple):
    """Spraying state carried in ``SimState.extra`` (multi-link runs only)."""
    mr: MatchRdmaState     # the shared budget block (budget traces)
    tokens: torch.Tensor   # [B, L] per-link spray tokens, bytes
    tx_cum: torch.Tensor   # [B, L, F] cumulative bytes sprayed per link
    arr_cum: torch.Tensor  # [B, L, F] cumulative bytes arrived per link


def rob_bytes(ex: RdmaCellState) -> torch.Tensor:
    """``[B, F]`` estimated reorder-buffer occupancy per flow. A link's
    arrival frontier for a flow is its cumulative arrivals over its share of
    the flow's transmissions; in-order delivery reaches the slowest
    frontier, and what arrived beyond it waits in the ROB."""
    tx_tot = ex.tx_cum.sum(-2)                                  # [B, F]
    arr_tot = ex.arr_cum.sum(-2)
    share = ex.tx_cum / torch.clamp(tx_tot[..., None, :], min=1.0)
    est = torch.where(share > 1e-6,
                      ex.arr_cum / torch.clamp(share, min=1e-6), torch.inf)
    frontier = est.amin(-2)
    frontier = torch.where(torch.isfinite(frontier), frontier, arr_tot)
    return torch.clamp(arr_tot - torch.minimum(frontier, arr_tot), min=0.0)


class RdmaCellScheme(Scheme):
    """Token-gated flowcell spraying with ROB back-pressure."""

    def init_extra_state(self, cfg, params, num_flows: int, *,
                         history_slots: int = 0, chan_delay_pad: int = 0):
        mr = super().init_extra_state(cfg, params, num_flows,
                                      history_slots=history_slots,
                                      chan_delay_pad=chan_delay_pad)
        if cfg.num_paths <= 1:
            return mr  # single pipe: be the baseline, bit for bit
        link_caps = params.link_cap_gbps * 1e9 / 8.0            # [B, L]
        tokens = params.rdmacell_token_bucket_us[..., None] * 1e-6 * link_caps
        z = torch.zeros(*link_caps.shape, num_flows, device=link_caps.device)
        return RdmaCellState(mr=mr, tokens=tokens, tx_cum=z, arr_cum=z.clone())

    def route_weights(self, ctx: SchemeCtx, state, base_route):
        ex = state.extra
        if not isinstance(ex, RdmaCellState):
            return apply_link_live(ctx, base_route)
        tok = torch.clamp(ex.tokens, min=0.0)
        # all (live) buckets dry: fall back to the workload's own weights
        live_tok = (tok * ctx.link_live if ctx.link_live is not None
                    else tok).sum(-1)
        tok = torch.where((live_tok <= 0.0)[..., None], 1.0, tok)
        return apply_link_live(ctx, base_route * tok[..., None, :])

    def sender_rate(self, ctx: SchemeCtx, state, base_rate):
        rate = super().sender_rate(ctx, state, base_rate)
        ex = state.extra
        if not isinstance(ex, RdmaCellState):
            return rate
        rob_tot = (rob_bytes(ex) * ctx.is_inter).sum(-1)
        limit = ctx.params.rdmacell_rob_limit_mb * 1e6
        gate = torch.where(rob_tot > limit,
                           limit / torch.clamp(rob_tot, min=1.0), 1.0)
        return torch.where(ctx.is_inter > 0, rate * gate[..., None], rate)

    def feedback(self, ctx: SchemeCtx, state, sig: SchemeSignals) -> Feedback:
        fb = super().feedback(ctx, state, sig)
        ex = state.extra
        if not isinstance(ex, RdmaCellState):
            return fb
        bucket = (ctx.params.rdmacell_token_bucket_us[..., None] * 1e-6
                  * ctx.link_caps)
        # refill with what the link could carry, drain with what was offered
        tokens = torch.minimum(
            torch.clamp(ex.tokens + sig.link_cap - sig.link_want, min=0.0),
            bucket)
        return fb._replace(extra=ex._replace(
            tokens=tokens, tx_cum=ex.tx_cum + sig.link_sent,
            arr_cum=ex.arr_cum + sig.link_arrivals))

    def extra_traces(self, ctx: SchemeCtx, state) -> dict:
        ex = state.extra
        if not isinstance(ex, RdmaCellState):
            return super().extra_traces(ctx, state)
        return {
            "budget": ex.mr.budget.budget,
            "budget_at_src": ex.mr.budget_at_src,
            "rdmacell_rob_mb": (rob_bytes(ex) * ctx.is_inter).sum(-1) / 1e6,
            "rdmacell_tokens_mb": ex.tokens.sum(-1) / 1e6,
        }

    def init_metric_acc(self, ctx: SchemeCtx, state) -> dict:
        ex = state.extra
        if not isinstance(ex, RdmaCellState):
            return super().init_metric_acc(ctx, state)
        z = torch.zeros_like(ex.mr.budget.budget)
        return {"budget_sum": z, "rob_sum": z.clone(),
                "tx_by_link": torch.zeros_like(ex.tokens)}

    def accumulate_metrics(self, ctx: SchemeCtx, acc, state, out, inc):
        if "rob_sum" not in acc:
            return super().accumulate_metrics(ctx, acc, state, out, inc)
        ex = state.extra
        rob = (rob_bytes(ex) * ctx.is_inter).sum(-1)
        return dict(acc,
                    budget_sum=acc["budget_sum"] + ex.mr.budget.budget * inc,
                    rob_sum=acc["rob_sum"] + rob * inc,
                    tx_by_link=ex.tx_cum.sum(-1))

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int) -> dict:
        if "rob_sum" not in acc:
            return super().finalize_metrics(acc, n_steps, n_warm)
        cols = {
            "mean_budget_gbps": np.asarray(acc["budget_sum"])
            / max(n_warm, 1) * 8.0 / 1e9,
            "mean_reorder_buf_mb": np.asarray(acc["rob_sum"])
            / max(n_warm, 1) / 1e6,
        }
        tx = np.asarray(acc["tx_by_link"])
        batched = tx.ndim == 2
        tx = np.atleast_2d(tx)                                    # [B, L]
        p = tx / np.maximum(tx.sum(axis=1, keepdims=True), 1.0)
        h = -np.where(p > 0.0, p * np.log(np.maximum(p, 1e-30)),
                      0.0).sum(axis=1)
        n_links = tx.shape[1]
        # normalised to [0, 1]: 1 = an even spray, 0 = one link or no traffic
        ent = h / np.log(n_links) if n_links > 1 else np.zeros(tx.shape[0])
        ent = np.where(tx.sum(axis=1) > 0.0, ent, 0.0)
        cols["spray_entropy"] = ent if batched else float(ent[0])
        return cols
