"""The composed MatchRDMA controller - three coordinated segments (Fig. 2(a)).

  SOURCE-SIDE LOOP      budget-gated pseudo-ACK (pseudo_ack.py) + the proxy
                        brake driven by the destination's congestion summaries.
  INTER-OTN LOOP        control subchannel carrying (budget, summary)
                        DST -> SRC with one-way delay D (budget.py).
  DESTINATION-SIDE LOOP slot observations (slots.py) -> slot-weighted /
                        periodic rate estimation (estimator.py) -> budget
                        generation (budget.py).

``MatchRdmaState`` rides in ``SimState.extra``; the ``matchrdma`` scheme's
``feedback`` hook runs the per-step parts every fluid step and
``maybe_slot_update`` at slot boundaries. The JAX package's
``core/matchrdma.py``; with a temperature (``soft``) the slot update's gates
are tempered (``netsim.soft``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.config.net import NetParams
from repro_torch.core.budget import (
    BudgetState, ControlChannel, channel_send_recv, control_proc_steps_traced,
    ctrl_window_slots, ctrl_window_slots_traced, init_budget, init_channel,
    update_budget,
)
from repro_torch.core.estimator import (
    periodic_from_history, slot_weighted_from_history,
)
from repro_torch.core.pseudo_ack import PseudoAckState, init_pseudo_ack
from repro_torch.core.slots import (
    SlotObs, SlotRing, init_ring, ordered_history, push_slot,
)
from repro_torch.netsim.soft import clip, soft_gt

_ACC = ("acc_egress", "acc_cnp", "acc_ack_delay", "acc_ack_n", "acc_queue",
        "acc_paused")


class MatchRdmaState(NamedTuple):
    ring: SlotRing               # destination slot history
    budget: BudgetState          # destination budget state
    chan: ControlChannel         # DST -> SRC control subchannel
    budget_at_src: torch.Tensor  # budget currently known at source
    summary_at_src: torch.Tensor  # congestion summary at source
    pseudo: PseudoAckState       # source pseudo-ACK bookkeeping
    # per-slot accumulators (reset at slot boundary)
    acc_egress: torch.Tensor     # bytes forwarded this slot
    acc_cnp: torch.Tensor        # CNPs this slot
    acc_ack_delay: torch.Tensor  # summed ack-delay observations
    acc_ack_n: torch.Tensor      # count of ack-delay observations
    acc_queue: torch.Tensor      # summed local-queue occupancy samples
    acc_paused: torch.Tensor     # steps this slot with egress PFC-paused


def default_history_slots(cfg) -> int:
    """Slot-ring size covering at least two control windows of history,
    rounded up to whole estimator windows."""
    spw = cfg.slots_per_window
    want = max(64, 2 * ctrl_window_slots(cfg))
    return ((want + spw - 1) // spw) * spw


def init_matchrdma(cfg, num_flows: int, history_slots: int = 0,
                   params: NetParams = None,
                   chan_delay_pad: int = 0) -> MatchRdmaState:
    """``history_slots`` / ``chan_delay_pad`` are ring sizes (0 = size for
    ``cfg``); a batch pads them to its largest scenario, and each scenario's
    channel wraps at its own delay from ``params``."""
    if history_slots <= 0:
        history_slots = default_history_slots(cfg)
    if chan_delay_pad <= 0:
        chan_delay_pad = cfg.static_delay_steps + cfg.control_proc_steps
    if params is None:
        actual_delay = chan_delay_pad
    else:
        actual_delay = (params.delay_steps(cfg.dt_us)
                        + control_proc_steps_traced(cfg, params))
    budget0 = init_budget(cfg, params)
    bs, dev = budget0.budget.shape, budget0.budget.device
    z = torch.zeros(bs, device=dev)
    return MatchRdmaState(
        ring=init_ring(history_slots, bs, dev),
        budget=budget0,
        chan=init_channel(chan_delay_pad, cfg, params=params,
                          actual_delay=actual_delay),
        budget_at_src=budget0.budget.clone(),
        summary_at_src=z,
        pseudo=init_pseudo_ack(num_flows, bs, dev),
        **{k: z.clone() for k in _ACC},
    )


def accumulate_step(state: MatchRdmaState, egress_bytes, cnp_count,
                    ack_delay_us, ack_n, queue_bytes,
                    egress_paused=None) -> MatchRdmaState:
    """Cheap per-fluid-step accumulation at the destination OTN."""
    if egress_paused is None:
        egress_paused = 0.0
    return state._replace(
        acc_egress=state.acc_egress + egress_bytes,
        acc_cnp=state.acc_cnp + cnp_count,
        acc_ack_delay=state.acc_ack_delay + ack_delay_us,
        acc_ack_n=state.acc_ack_n + ack_n,
        acc_queue=state.acc_queue + queue_bytes,
        acc_paused=state.acc_paused + egress_paused,
    )


def step_channel(state: MatchRdmaState, summary=None,
                 inplace: bool = True) -> MatchRdmaState:
    """Advance the control subchannel by one fluid step (every step).
    ``summary`` is the destination OTN's own overload flag (default: any CNP
    this slot); ``inplace=False`` writes the lines into new tensors."""
    if summary is None:
        summary = state.acc_cnp > 0
    chan, b_src, s_src = channel_send_recv(
        state.chan, state.budget.budget, summary.to(torch.float32), inplace)
    return state._replace(chan=chan, budget_at_src=b_src,
                          summary_at_src=s_src)


def slot_update(state: MatchRdmaState, cfg, period_slots: int = 0,
                params: NetParams = None, soft=None) -> MatchRdmaState:
    """Run at each slot boundary: classify, estimate, regenerate budget.
    With ``params`` the slot length is each scenario's ``params.slot_us``;
    without, the static ``cfg.slot_us``. ``soft`` (the temperature) relaxes
    the busy, classifier and budget gates."""
    if params is None:
        slot_s = cfg.slot_us * 1e-6
        steps_per_slot = max(int(round(cfg.slot_us / cfg.dt_us)), 1)
    else:
        slot_s = params.slot_us * 1e-6
        steps_per_slot = clip(torch.round(params.slot_us / cfg.dt_us), 1.0)
    # pause-corrected egress rate: bytes / UNPAUSED time
    paused_frac = state.acc_paused / steps_per_slot
    unpaused_s = slot_s * clip(1.0 - paused_frac, 1e-3)
    mean_queue = state.acc_queue / steps_per_slot
    obs = SlotObs(
        egress_rate=state.acc_egress / unpaused_s,
        ack_delay_us=state.acc_ack_delay / clip(state.acc_ack_n, 1.0),
        cnp_count=state.acc_cnp,
        local_queue=mean_queue,
    )
    queue_thresh = (cfg.queue_thresh_kb if params is None
                    else params.queue_thresh_kb) * 1024.0
    # capability is only measurable when backlogged AND mostly unpaused
    if soft is None:
        busy = ((mean_queue > queue_thresh)
                & (paused_frac < 0.9)).to(torch.float32)
    else:
        busy = (soft_gt(mean_queue, queue_thresh, soft,
                        0.05 * queue_thresh + 1.0)
                * soft_gt(0.9, paused_frac, soft, 0.1))
    ring = push_slot(state.ring, obs, cfg, busy=busy,
                     queue_thresh_bytes=queue_thresh, soft=soft)
    history = ordered_history(ring)
    if period_slots > 0:
        est = periodic_from_history(history, cfg, period_slots, soft=soft)
    else:
        est = slot_weighted_from_history(history, cfg, soft=soft)
    # fraction of the last control window flagged congested
    _, congested_hist, _, valid = history
    r = congested_hist.shape[-1]
    pos = torch.arange(r, device=valid.device)
    floor_slots = 4 * cfg.slots_per_window
    if params is None:
        ctrl_slots = ctrl_window_slots(cfg)
        recent = pos >= r - min(max(ctrl_slots, floor_slots), r)
    else:
        ctrl_slots = ctrl_window_slots_traced(params, cfg)
        n_recent = torch.clamp(torch.clamp(ctrl_slots, min=floor_slots), 1, r)
        recent = pos >= (r - n_recent)[..., None]
    recent_valid = valid * recent.to(torch.float32)
    cong_recent = ((congested_hist * recent_valid).sum(-1)
                   / torch.clamp(recent_valid.sum(-1), min=1.0))
    budget = update_budget(state.budget, est, state.acc_cnp, cong_recent, cfg,
                           ctrl_slots=ctrl_slots, params=params, soft=soft)
    z = torch.zeros_like(state.acc_egress)
    return state._replace(ring=ring, budget=budget, **{k: z for k in _ACC})


def maybe_slot_update(state: MatchRdmaState, cfg, step_idx,
                      period_slots: int = 0, params: NetParams = None,
                      soft=None, host_t: Optional[int] = None,
                      slot_steps: Sequence[int] = ()) -> MatchRdmaState:
    """Branchless slot update: computed every step, selected where
    ``step_idx`` ends a slot, so the step holds no host decision. The
    boundary is an exact integer comparison on each scenario's
    steps-per-slot, in soft mode too: slot cadence is simulator structure,
    not a knob threshold. The eager soft step passes its index on the host
    (``host_t``) and each scenario's steps per slot (``slot_steps``) and
    skips the update off every boundary, with no device read."""
    if params is None:
        steps_per_slot = max(int(round(cfg.slot_us / cfg.dt_us)), 1)
    else:
        steps_per_slot = torch.clamp(
            torch.round(params.slot_us / cfg.dt_us).to(torch.int32), min=1)
    if host_t is not None and all((host_t + 1) % n for n in slot_steps):
        # off every scenario's slot boundary the select below would discard
        # the update (and send it no gradient), so it is not computed
        return state
    at = torch.remainder(step_idx + 1, steps_per_slot) == 0
    new = slot_update(state, cfg, period_slots, params=params, soft=soft)
    at_r = at[..., None]
    ring = SlotRing(*(torch.where(at_r if a.dim() > at.dim() else at, a, b)
                      for a, b in zip(new.ring, state.ring)))
    budget = BudgetState(*(torch.where(at, a, b)
                           for a, b in zip(new.budget, state.budget)))
    return state._replace(
        ring=ring, budget=budget,
        **{k: torch.where(at, 0.0, getattr(state, k)) for k in _ACC})
