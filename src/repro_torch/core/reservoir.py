"""Reservoir model of destination-OTN buffer stress: Eq. (1) of the paper.

Two coupled reservoirs linked by a long-haul pipe with one-way delay D.
Arrivals at the destination OTN are the D-delayed source output process;
the destination forwards into the receiving AI-DC at r_out(t). The minimum
runtime buffer is governed by the accumulated rate mismatch over the
control-uncertainty window tau:

    B_req >= sup_t int_t^{t+tau} ( r_in(u) - r_out(u) )+ du          (Eq. 1)

The torch twin of the JAX package's ``core/reservoir.py``: the same five
functions, on 1-D float32 tensors (rates on a common step grid) and Python
floats.
"""
from __future__ import annotations

import torch


def rate_mismatch_integral(r_in: torch.Tensor, r_out: torch.Tensor, dt: float,
                           tau_steps: int) -> torch.Tensor:
    """int_t^{t+tau} (r_in - r_out)+ du for every t, via a cumulative-sum window.

    r_in, r_out: [T] rates (bytes/s) on a common grid of step dt (s).
    Returns [T]; entries within tau of the end use the truncated window.
    """
    excess = torch.clamp(r_in - r_out, min=0.0) * dt           # bytes per step
    cs = torch.cat([excess.new_zeros(1), torch.cumsum(excess, 0)])   # [T+1]
    t = excess.shape[0]
    idx = torch.arange(t, device=excess.device)
    return cs[torch.clamp(idx + tau_steps, max=t)] - cs[idx]


def required_buffer(r_in: torch.Tensor, r_out: torch.Tensor, dt: float,
                    tau_steps: int) -> torch.Tensor:
    """B_req = sup_t of the windowed mismatch integral (Eq. 1)."""
    return rate_mismatch_integral(r_in, r_out, dt, tau_steps).max()


def queue_trajectory(r_in: torch.Tensor, r_out_cap: torch.Tensor, dt: float,
                     q0: float = 0.0) -> torch.Tensor:
    """Lindley recursion: q_{t+1} = (q_t + (r_in - r_out_cap)·dt)+.

    ``r_out_cap`` is the *capacity* of the drain (the realized drain is
    min(capacity, backlog/dt + arrivals)). Returns the queue series [T].
    """
    inc = (r_in - r_out_cap) * dt
    qs = torch.empty_like(inc)
    q = torch.tensor(q0, dtype=inc.dtype, device=inc.device)
    for i in range(inc.shape[0]):
        q = torch.clamp(q + inc[i], min=0.0)
        qs[i] = q
    return qs


def control_uncertainty_window_us(one_way_delay_us: float,
                                  proc_delay_us: float = 0.0,
                                  slot_us: float = 0.0) -> float:
    """tau for the segmented scheme: budget feedback takes one OTN-to-OTN
    propagation (D) + control processing + up to one slot of estimation lag.

    For *end-to-end* control (DCQCN baseline), tau is about 2·D + receiver
    processing: twice as large, which is why the paper's segmented control
    shrinks B_req.
    """
    return one_way_delay_us + proc_delay_us + slot_us


def buffer_bound_e2e_vs_segmented(peak_rate: float, matched_rate: float,
                                  one_way_delay_us: float, slot_us: float):
    """Worst-case B_req when the drain drops to ``matched_rate`` while the
    source still injects ``peak_rate`` for a full control window.

    Returns (B_e2e, B_segmented) in bytes. peak/matched in bytes/s.
    """
    tau_e2e = 2.0 * one_way_delay_us * 1e-6
    tau_seg = (one_way_delay_us + slot_us) * 1e-6
    excess = max(peak_rate - matched_rate, 0.0)
    return excess * tau_e2e, excess * tau_seg
