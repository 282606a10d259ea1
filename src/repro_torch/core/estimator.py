"""Slot-weighted rate estimation (Fig. 2(e), right half).

From the slot history the destination OTN groups consecutive slots into
windows of ``slots_per_window``, classifies each window as stable (low
coefficient of variation, no congestion flags) or jitter-dominated, and
estimates the sustainable inter-DC rate as a recency- and
stability-weighted mean; rates seen while backlogged estimate the
forwarding capability. ``periodic_estimate`` adds the LLM-periodicity
forecast. The JAX package's ``core/estimator.py``; with a temperature
(``soft``) the stability and periodicity gates are tempered sigmoids
(``netsim.soft``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.slots import SlotRing, ordered_history
from repro_torch.netsim.soft import clip, lerp, magnitude, soft_gt, soft_pos

_EPS = 1e-9


class RateEstimate(NamedTuple):
    rate: torch.Tensor             # bytes/s - the slot-weighted estimate
    stable_frac: torch.Tensor      # fraction of windows classified stable
    recurrent: torch.Tensor        # 1.0 if the periodic predictor fired
    capability: torch.Tensor       # bytes/s - busy-slot capability estimate
    have_capability: torch.Tensor  # 1.0 once any busy slot has been observed


def window_stats(rates, congested, busy, valid, slots_per_window: int,
                 soft=None):
    """Cut oldest-first history into windows; per-window mean, CV, flags.
    ``soft`` only swaps the std for ``sqrt(var + 1e-12)``: at a constant
    window the std's derivative is infinite."""
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
    if soft is None:
        std = rw.std(-1, correction=0)
    else:
        std = torch.sqrt(rw.var(-1, correction=0) + 1e-12)
    cv = std / clip(mean, _EPS)
    cong = cw.amax(-1)
    busy_frac = bw.mean(-1)
    return mean, cv, cong, busy_frac, w_valid


def slot_weighted_from_history(history: tuple, cfg, soft=None) -> RateEstimate:
    """``slot_weighted_estimate`` of an ``ordered_history`` already taken."""
    rates, congested, busy, valid = history
    mean, cv, cong, busy_frac, w_valid = window_stats(
        rates, congested, busy, valid, cfg.slots_per_window, soft=soft)
    if soft is None:
        stable = ((cv < cfg.stable_cv_thresh) & (cong < 0.5)).to(torch.float32)
        w = torch.where(stable > 0, cfg.stable_weight,
                        cfg.jitter_weight) * w_valid
    else:
        stable = (soft_gt(cfg.stable_cv_thresh, cv, soft, 0.05)
                  * soft_gt(0.5, cong, soft, 0.25))
        w = lerp(stable, np.float32(cfg.stable_weight),
                 np.float32(cfg.jitter_weight)) * w_valid
    # recency weighting: newer windows count more (linear ramp 0.5 .. 1.0)
    nw = mean.shape[-1]
    recency = 0.5 + 0.5 * (torch.arange(nw, device=mean.device) + 1) / nw
    w = w * recency
    est = (w * mean).sum(-1) / clip(w.sum(-1), _EPS)
    stable_frac = ((stable * w_valid).sum(-1) / clip(w_valid.sum(-1), _EPS))
    # forwarding capability: rates observed while BACKLOGGED
    wcap = w * busy_frac
    wcap_sum = wcap.sum(-1)
    if soft is None:
        have_cap = (wcap_sum > _EPS).to(torch.float32)
    else:
        # soft_pos is exactly 0 at 0: no busy slot ever, no capability
        have_cap = soft_pos(wcap_sum - _EPS, soft, 0.25)
    cap = (wcap * mean).sum(-1) / clip(wcap_sum, _EPS)
    return RateEstimate(rate=est, stable_frac=stable_frac,
                        recurrent=torch.zeros_like(est),
                        capability=cap, have_capability=have_cap)


def slot_weighted_estimate(ring: SlotRing, cfg, soft=None) -> RateEstimate:
    return slot_weighted_from_history(ordered_history(ring), cfg, soft=soft)


def periodic_from_history(history: tuple, cfg, period_slots: int,
                          soft=None) -> RateEstimate:
    """``periodic_estimate`` of an ``ordered_history`` already taken."""
    base = slot_weighted_from_history(history, cfg, soft=soft)
    rates, _, _, valid = history
    r = rates.shape[-1]
    spw = cfg.slots_per_window
    if r < period_slots + 2 * spw or period_slots <= spw:
        return base
    cur = rates[..., r - spw:r]
    hist = rates[..., r - spw - period_slots:r - period_slots]
    nxt = rates[..., r - period_slots:r - period_slots + spw]
    cur_valid = valid[..., r - spw - period_slots:r - period_slots]
    denom = clip(magnitude(cur).mean(-1), _EPS)
    rel = magnitude(cur - hist).mean(-1) / denom
    forecast = nxt.mean(-1)
    if soft is None:
        match = (rel < cfg.stable_cv_thresh) & (cur_valid.amin(-1) > 0)
        # the recurrent forecast replaces the base estimate when it fires
        return base._replace(rate=torch.where(match, forecast, base.rate),
                             recurrent=match.to(torch.float32))
    # the validity mask is count-driven (no knob in it): a hard multiplier;
    # only the similarity gate is tempered
    w_valid = (cur_valid.amin(-1) > 0).to(torch.float32)
    recurrent = soft_gt(cfg.stable_cv_thresh, rel, soft, 0.05) * w_valid
    return base._replace(rate=lerp(recurrent, forecast, base.rate),
                         recurrent=recurrent)


def periodic_estimate(ring: SlotRing, cfg, period_slots: int,
                      soft=None) -> RateEstimate:
    """Seasonal forecast keyed to the LLM iteration period: if the latest
    window matches the same-phase window one period earlier, forecast the
    rates that followed it; else the slot-weighted estimate."""
    return periodic_from_history(ordered_history(ring), cfg, period_slots,
                                 soft=soft)
