"""DCQCN rate machine, vectorized over flows (the hard path of the JAX
package's ``core/cc_proxy.py``), and the THEMIS RTT-fairness factor.

The same machine runs at the SENDER for the DCQCN / pseudo-ACK / THEMIS
baselines and, for MatchRDMA's intra-DC flows, beside the source-OTN proxy.
State follows Zhu et al. (SIGCOMM'15): per-flow current rate Rc, target Rt,
alpha; an alpha-update timer; rate-increase timer + byte counter driving
fast-recovery / additive / hyper increase stages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_F = 5  # fast-recovery stage count


class DcqcnState(NamedTuple):
    rc: torch.Tensor           # [..., F] current rate (bytes/s)
    rt: torch.Tensor           # [..., F] target rate
    alpha: torch.Tensor        # [..., F]
    t_alpha: torch.Tensor      # [..., F] us since last alpha update
    t_rate: torch.Tensor       # [..., F] us since last rate-increase event
    bytes_ctr: torch.Tensor    # [..., F] bytes since last byte-counter event
    stage_t: torch.Tensor      # [..., F] timer stages since last cut
    stage_b: torch.Tensor      # [..., F] byte stages since last cut


def init_dcqcn(num_flows: int, line_rate: torch.Tensor) -> DcqcnState:
    """``line_rate``: per-scenario bytes/s, 0-d or ``[B]``."""
    rate = line_rate[..., None].expand(*line_rate.shape, num_flows).contiguous()
    z = torch.zeros_like(rate)
    return DcqcnState(rc=rate, rt=rate.clone(), alpha=torch.ones_like(rate),
                      t_alpha=z, t_rate=z.clone(), bytes_ctr=z.clone(),
                      stage_t=z.clone(), stage_b=z.clone())


def step_dcqcn(state: DcqcnState, cnp: torch.Tensor, sent_bytes: torch.Tensor,
               cfg, *, rtt_scale: torch.Tensor = None) -> DcqcnState:
    """One step: ``cnp`` [..., F] 0/1 (a CNP arrived), ``sent_bytes`` bytes
    sent this step, ``rtt_scale`` the THEMIS factor (None = 1)."""
    dt = cfg.dt_us
    g = cfg.dcqcn_g
    rai = cfg.dcqcn_rai_mbps * 1e6 / 8.0
    rhai = cfg.dcqcn_hai_mbps * 1e6 / 8.0
    rmin = cfg.min_rate_mbps * 1e6 / 8.0

    # --- rate cut on CNP (THEMIS: attenuate for long-RTT flows) ---
    alpha_eff = state.alpha if rtt_scale is None else state.alpha / rtt_scale
    rc_cut = torch.clamp(state.rc * (1.0 - alpha_eff / 2.0), min=rmin)
    rt_cut = state.rc
    alpha_cut = (1.0 - g) * state.alpha + g

    t_alpha = state.t_alpha + dt
    t_rate = state.t_rate + dt
    bytes_ctr = state.bytes_ctr + sent_bytes

    cut = cnp > 0
    # --- alpha decay timer ---
    alpha_dec = t_alpha >= cfg.dcqcn_alpha_timer_us
    alpha_no = torch.where(alpha_dec, (1.0 - g) * state.alpha, state.alpha)
    t_alpha_no = torch.where(alpha_dec, 0.0, t_alpha)

    # --- rate increase events (timer and byte counter) ---
    timer_fire = t_rate >= cfg.dcqcn_rate_timer_us
    byte_fire = bytes_ctr >= cfg.dcqcn_bytes_counter_mb * 1e6
    fire = timer_fire | byte_fire
    stage_t = torch.where(timer_fire, state.stage_t + 1, state.stage_t)
    stage_b = torch.where(byte_fire, state.stage_b + 1, state.stage_b)
    max_stage = torch.maximum(stage_t, stage_b)

    hyper = (stage_t > _F) & (stage_b > _F)
    additive = (max_stage > _F) & ~hyper
    inc = torch.where(hyper, rhai, torch.where(additive, rai, 0.0))
    if rtt_scale is not None:
        inc = inc * rtt_scale
    rt_inc = torch.where(fire, state.rt + inc, state.rt)
    rc_inc = torch.where(fire, 0.5 * (state.rc + rt_inc), state.rc)

    # --- merge: cut dominates ---
    rc = torch.where(cut, rc_cut, rc_inc)
    rt = torch.where(cut, rt_cut, rt_inc)
    alpha = torch.where(cut, alpha_cut, alpha_no)
    return DcqcnState(
        rc=torch.clamp(rc, min=rmin),
        rt=rt,
        alpha=torch.clamp(alpha, 0.0, 1.0),
        t_alpha=torch.where(cut, 0.0, t_alpha_no),
        t_rate=torch.where(cut | fire, 0.0, t_rate),
        bytes_ctr=torch.where(cut | byte_fire, 0.0, bytes_ctr),
        stage_t=torch.where(cut, 0.0, stage_t),
        stage_b=torch.where(cut, 0.0, stage_b),
    )


def themis_rtt_scale(rtt_us: torch.Tensor, rtt_ref_us: float = 10.0,
                     cap: float = 4.0) -> torch.Tensor:
    """RTT-aware fairness factor (sqrt-damped, clipped): long-haul flows
    increase faster / cut softer so short-loop flows cannot starve them."""
    return torch.clamp(torch.sqrt(rtt_us / rtt_ref_us), 1.0, cap)
