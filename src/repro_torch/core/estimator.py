"""Slot-weighted rate estimation (Fig. 2(e), right half).

From the slot history the destination OTN groups consecutive slots into
windows of ``slots_per_window``, classifies each window as stable (low
coefficient of variation, no congestion flags) or jitter-dominated, and
estimates the sustainable inter-DC rate as a recency- and
stability-weighted mean; rates seen while backlogged estimate the
forwarding capability. ``periodic_estimate`` adds the LLM-periodicity
forecast. The hard paths of the JAX package's ``core/estimator.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.slots import SlotRing, ordered_history

_EPS = 1e-9


class RateEstimate(NamedTuple):
    rate: torch.Tensor             # bytes/s - the slot-weighted estimate
    stable_frac: torch.Tensor      # fraction of windows classified stable
    recurrent: torch.Tensor        # 1.0 if the periodic predictor fired
    capability: torch.Tensor       # bytes/s - busy-slot capability estimate
    have_capability: torch.Tensor  # 1.0 once any busy slot has been observed


def window_stats(rates, congested, busy, valid, slots_per_window: int):
    """Cut oldest-first history into windows; per-window mean, CV, flags."""
    r = rates.shape[-1]
    nw = r // slots_per_window
    cut = nw * slots_per_window
    shape = rates.shape[:-1] + (nw, slots_per_window)
    rw = rates[..., :cut].reshape(shape)
    cw = congested[..., :cut].reshape(shape)
    bw = busy[..., :cut].reshape(shape)
    vw = valid[..., :cut].reshape(shape)
    w_valid = vw.amin(-1)                                  # window fully valid
    mean = rw.mean(-1)
    std = rw.std(-1, correction=0)
    cv = std / torch.clamp(mean, min=_EPS)
    cong = cw.amax(-1)
    busy_frac = bw.mean(-1)
    return mean, cv, cong, busy_frac, w_valid


def slot_weighted_from_history(history: tuple, cfg) -> RateEstimate:
    """``slot_weighted_estimate`` of an ``ordered_history`` already taken."""
    rates, congested, busy, valid = history
    mean, cv, cong, busy_frac, w_valid = window_stats(
        rates, congested, busy, valid, cfg.slots_per_window)
    stable = ((cv < cfg.stable_cv_thresh) & (cong < 0.5)).to(torch.float32)
    w = torch.where(stable > 0, cfg.stable_weight, cfg.jitter_weight) * w_valid
    # recency weighting: newer windows count more (linear ramp 0.5 .. 1.0)
    nw = mean.shape[-1]
    recency = 0.5 + 0.5 * (torch.arange(nw, device=mean.device) + 1) / nw
    w = w * recency
    est = (w * mean).sum(-1) / torch.clamp(w.sum(-1), min=_EPS)
    stable_frac = ((stable * w_valid).sum(-1)
                   / torch.clamp(w_valid.sum(-1), min=_EPS))
    # forwarding capability: rates observed while BACKLOGGED
    wcap = w * busy_frac
    wcap_sum = wcap.sum(-1)
    have_cap = (wcap_sum > _EPS).to(torch.float32)
    cap = (wcap * mean).sum(-1) / torch.clamp(wcap_sum, min=_EPS)
    return RateEstimate(rate=est, stable_frac=stable_frac,
                        recurrent=torch.zeros_like(est),
                        capability=cap, have_capability=have_cap)


def slot_weighted_estimate(ring: SlotRing, cfg) -> RateEstimate:
    return slot_weighted_from_history(ordered_history(ring), cfg)


def periodic_from_history(history: tuple, cfg,
                          period_slots: int) -> RateEstimate:
    """``periodic_estimate`` of an ``ordered_history`` already taken."""
    base = slot_weighted_from_history(history, cfg)
    rates, _, _, valid = history
    r = rates.shape[-1]
    spw = cfg.slots_per_window
    if r < period_slots + 2 * spw or period_slots <= spw:
        return base
    cur = rates[..., r - spw:r]
    hist = rates[..., r - spw - period_slots:r - period_slots]
    nxt = rates[..., r - period_slots:r - period_slots + spw]
    cur_valid = valid[..., r - spw - period_slots:r - period_slots]
    denom = torch.clamp(cur.abs().mean(-1), min=_EPS)
    rel = (cur - hist).abs().mean(-1) / denom
    forecast = nxt.mean(-1)
    match = (rel < cfg.stable_cv_thresh) & (cur_valid.amin(-1) > 0)
    # the recurrent forecast replaces the base estimate when it fires
    return base._replace(rate=torch.where(match, forecast, base.rate),
                         recurrent=match.to(torch.float32))


def periodic_estimate(ring: SlotRing, cfg, period_slots: int) -> RateEstimate:
    """Seasonal forecast keyed to the LLM iteration period: if the latest
    window matches the same-phase window one period earlier, forecast the
    rates that followed it; else the slot-weighted estimate."""
    return periodic_from_history(ordered_history(ring), cfg, period_slots)
