"""Rate-budget generation + inter-OTN signalling (the middle segment).

The destination OTN turns the slot-weighted estimate into a budget
(headroom-scaled, floored, CNP-tightened) and ships it to the source OTN on a
control subchannel modeled as a lossless delay line (one-way propagation D +
``control_proc_slots`` slots of processing). The JAX package's
``core/budget.py``; with a temperature (``soft``) every threshold select of
the budget update is a tempered blend (``netsim.soft``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.config.net import NetParams
from repro_torch.core.estimator import RateEstimate
from repro_torch.netsim.soft import clip, lerp, reset_gate, soft_gt


class BudgetState(NamedTuple):
    budget: torch.Tensor         # bytes/s - current budget at the DESTINATION
    tighten: torch.Tensor        # multiplicative reactive tightening in (0,1]
    slots_clear: torch.Tensor    # consecutive clear slots since last raise
    cap_ewma: torch.Tensor       # sticky EWMA of measured forwarding capability
    have_cap: torch.Tensor       # 1.0 once capability has ever been measured


def ctrl_window_slots(cfg) -> int:
    """The control-uncertainty window tau (Eq. 1) in slots: a budget raise is
    only observable after src<-budget (D) + effect->dst (D) + one slot."""
    return max(int(math.ceil(2.0 * cfg.one_way_delay_us / cfg.slot_us)) + 1, 4)


def ctrl_window_slots_traced(params: NetParams, cfg) -> torch.Tensor:
    """tau in slots from the per-scenario delay and slot length (f32)."""
    return torch.clamp(
        torch.ceil(2.0 * params.one_way_delay_us / params.slot_us) + 1.0,
        min=4.0)


def control_proc_steps_traced(cfg, params: NetParams) -> torch.Tensor:
    """Per-scenario twin of ``NetConfig.control_proc_steps`` (int32; floor
    reproduces the static property's ``int()`` truncation)."""
    return torch.floor(
        cfg.control_proc_slots * params.slot_us / cfg.dt_us).to(torch.int32)


def _initial_budget(cfg, params) -> torch.Tensor:
    """A quarter of the destination DC's drain rate, bytes/s: from the
    per-scenario f32 leaf, or from ``cfg`` in double rounded once."""
    dst = cfg.dst_dc_gbps if params is None else params.dst_dc_gbps
    return torch.as_tensor(dst * 1e9 / 8.0 * 0.25, dtype=torch.float32)


def init_budget(cfg, params: NetParams = None) -> BudgetState:
    """Proactive initial budget: a conservative fraction of the destination
    DC's drain capability, NOT the OTN line rate."""
    start = _initial_budget(cfg, params)
    z = torch.zeros_like(start)
    return BudgetState(budget=start, tighten=torch.ones_like(start),
                       slots_clear=z, cap_ewma=z.clone(), have_cap=z.clone())


def update_budget(state: BudgetState, est: RateEstimate,
                  cnp_in_slot: torch.Tensor, cong_recent: torch.Tensor, cfg,
                  ctrl_slots=1, params: NetParams = None,
                  soft=None) -> BudgetState:
    """Per-slot budget update at the destination OTN: match to the
    demonstrated capability when congested within the last control window,
    else open up (x2 before capability is known, ``budget_probe`` after) at
    one raise per control window. ``soft`` (the temperature) replaces every
    threshold select by a tempered blend."""
    if params is None:
        params = NetParams.of(cfg)
    cap = params.otn_capacity_gbps * 1e9 / 8.0
    floor = params.budget_floor_mbps * 1e6 / 8.0
    down = clip(state.tighten * 0.95, 0.7)
    up = clip(state.tighten * 1.02, hi=1.0)
    if soft is None:
        tighten = torch.where(cnp_in_slot > cfg.cnp_freq_thresh, down, up)
        # sticky EWMA capability: fold in fresh busy-slot measurements
        cap_ewma = torch.where(
            est.have_capability > 0,
            torch.where(state.have_cap > 0,
                        0.8 * state.cap_ewma + 0.2 * est.capability,
                        est.capability),
            state.cap_ewma)
    else:
        tighten = lerp(soft_gt(cnp_in_slot, cfg.cnp_freq_thresh, soft, 0.25),
                       down, up)
        # est.have_capability is itself a gate weight here, and have_cap
        # its running max: blend with them directly
        w_have = soft_gt(state.have_cap, 0.5, soft, 0.25)
        cap_ewma = lerp(
            est.have_capability,
            lerp(w_have, 0.8 * state.cap_ewma + 0.2 * est.capability,
                 est.capability),
            state.cap_ewma)
    have_cap = torch.maximum(state.have_cap, est.have_capability)
    declared = params.dst_dc_gbps * 1e9 / 8.0
    if soft is not None:
        return _soft_budget(state, est, cong_recent, cfg, ctrl_slots, params,
                            soft, cap, floor, tighten, cap_ewma, have_cap,
                            declared)
    known = have_cap > 0
    # match to demonstrated forwarding CAPABILITY, never to self-throttled
    # egress; fall back to the plain slot-weighted estimate early on.
    cap_rate = torch.where(known, cap_ewma, est.rate)
    matched = params.budget_headroom * cap_rate * tighten

    constrained = cong_recent > 0.02
    slots_clear = torch.where(constrained, 0.0, state.slots_clear + 1.0)
    raise_now = slots_clear >= ctrl_slots
    # a full clear control window at the current rate is capability evidence
    cap_ewma = torch.where(raise_now & known,
                           torch.maximum(cap_ewma, est.rate), cap_ewma)
    # never blind-probe above 1.1x the destination's own egress speed
    ceiling = torch.minimum(1.1 * torch.where(known, cap_ewma, declared), cap)
    factor = torch.where(known, cfg.budget_probe, 2.0)
    open_up = torch.where(raise_now,
                          torch.minimum(state.budget * factor, ceiling),
                          state.budget)
    slots_clear = torch.where(raise_now, 0.0, slots_clear)
    budget = torch.clamp(torch.where(constrained, matched, open_up),
                         min=floor, max=cap)
    return BudgetState(budget=budget, tighten=tighten,
                       slots_clear=slots_clear,
                       cap_ewma=cap_ewma, have_cap=have_cap)


def _soft_budget(state: BudgetState, est: RateEstimate, cong_recent, cfg,
                 ctrl_slots, params, soft, cap, floor, tighten, cap_ewma,
                 have_cap, declared) -> BudgetState:
    """The soft regimes of ``update_budget``. ``slots_clear`` is a phase
    counter: its resets take the detached gate (``netsim.soft.reset_gate``)."""
    w_known = soft_gt(have_cap, 0.5, soft, 0.25)
    matched = (params.budget_headroom * lerp(w_known, cap_ewma, est.rate)
               * tighten)
    w_con = soft_gt(cong_recent, 0.02, soft, 0.02)
    slots_clear = lerp(reset_gate(w_con), 0.0, state.slots_clear + 1.0)
    w_raise = soft_gt(slots_clear, ctrl_slots, soft, 1.0)
    cap_ewma = lerp(w_raise * w_known, torch.maximum(cap_ewma, est.rate),
                    cap_ewma)
    ceiling = torch.minimum(1.1 * lerp(w_known, cap_ewma, declared), cap)
    factor = lerp(w_known, np.float32(cfg.budget_probe), np.float32(2.0))
    open_up = lerp(w_raise, torch.minimum(state.budget * factor, ceiling),
                   state.budget)
    slots_clear = lerp(reset_gate(w_raise), 0.0, slots_clear)
    budget = clip(lerp(w_con, matched, open_up), floor, cap)
    return BudgetState(budget=budget, tighten=tighten,
                       slots_clear=slots_clear,
                       cap_ewma=cap_ewma, have_cap=have_cap)


class ControlChannel(NamedTuple):
    """Delay line carrying (budget, congestion summary) DST -> SRC.

    The line length (last axis) is the padded size shared by a batch;
    ``delay`` is each scenario's actual delay in steps (<= the padding), the
    point its ring index wraps at. ``channel_send_recv`` writes the lines in
    place."""
    line_budget: torch.Tensor    # [..., Dpad]
    line_summary: torch.Tensor   # [..., Dpad]
    idx: torch.Tensor            # [...] int32
    delay: torch.Tensor          # [...] int32 - actual delay (<= Dpad)


def init_channel(delay_steps: int, cfg, params: NetParams = None,
                 actual_delay=None, fill=None) -> ControlChannel:
    """``delay_steps`` sizes the line; ``actual_delay`` (int or per-scenario
    int tensor, default ``delay_steps``) is the wrap point. ``fill``
    overrides the initial value (default: the proactive initial budget)."""
    start = _initial_budget(cfg, params)
    if fill is not None:
        start = torch.full_like(start, fill)
    d = max(delay_steps, 1)
    if actual_delay is None:
        actual_delay = d
    line = start[..., None].expand(*start.shape, d).contiguous()
    delay = torch.as_tensor(actual_delay, dtype=torch.int32,
                            device=start.device).expand(start.shape)
    return ControlChannel(
        line_budget=line,
        line_summary=torch.zeros_like(line),
        idx=torch.zeros(start.shape, dtype=torch.int32, device=start.device),
        delay=torch.clamp(delay, 1, d).contiguous(),
    )


def channel_send_recv(chan: ControlChannel, budget: torch.Tensor,
                      summary: torch.Tensor, inplace: bool = True):
    """Pop the D-delayed (budget, summary) and push this step's in their
    place. Returns (channel with the next index, budget_at_src,
    summary_at_src). The lines are written in place, or into new tensors
    with ``inplace=False`` (the soft engine's, which autograd records)."""
    at = chan.idx[..., None].to(torch.int64)
    out_b = torch.gather(chan.line_budget, -1, at)[..., 0]
    out_s = torch.gather(chan.line_summary, -1, at)[..., 0]
    if inplace:
        chan.line_budget.scatter_(-1, at, budget[..., None])
        chan.line_summary.scatter_(-1, at, summary[..., None])
    else:
        chan = chan._replace(
            line_budget=chan.line_budget.scatter(-1, at, budget[..., None]),
            line_summary=chan.line_summary.scatter(-1, at, summary[..., None]))
    return (chan._replace(idx=torch.remainder(chan.idx + 1, chan.delay)),
            out_b, out_s)


def fair_share(budget_total: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Split the aggregate budget among active inter-DC flows (equal split
    of ``budget_total`` over the ``[..., F]`` 0/1 mask)."""
    n = clip(active.sum(-1), 1.0)
    return (budget_total / n)[..., None] * active
