"""DCQCN rate machine, vectorized over flows (the JAX package's
``core/cc_proxy.py``), and the THEMIS RTT-fairness factor.

The same machine runs at the SENDER for the DCQCN / pseudo-ACK / THEMIS
baselines and, for MatchRDMA's intra-DC flows, beside the source-OTN proxy.
State follows Zhu et al. (SIGCOMM'15): per-flow current rate Rc, target Rt,
alpha; an alpha-update timer; rate-increase timer + byte counter driving
fast-recovery / additive / hyper increase stages. With a temperature
(``soft``) every gate is a tempered sigmoid and every select a blend
(``netsim.soft``), converging to the hard machine as it goes to 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.netsim.soft import clip, lerp, reset_gate, soft_gt, soft_or

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
               cfg, *, rtt_scale: torch.Tensor = None, soft=None) -> DcqcnState:
    """One step: ``cnp`` [..., F] 0/1 (a CNP arrived), ``sent_bytes`` bytes
    sent this step, ``rtt_scale`` the THEMIS factor (None = 1), ``soft`` the
    temperature (None = the hard machine)."""
    dt = cfg.dt_us
    g = cfg.dcqcn_g
    rai = cfg.dcqcn_rai_mbps * 1e6 / 8.0
    rhai = cfg.dcqcn_hai_mbps * 1e6 / 8.0
    rmin = cfg.min_rate_mbps * 1e6 / 8.0

    # --- rate cut on CNP (THEMIS: attenuate for long-RTT flows) ---
    alpha_eff = state.alpha if rtt_scale is None else state.alpha / rtt_scale
    rc_cut = clip(state.rc * (1.0 - alpha_eff / 2.0), rmin)
    rt_cut = state.rc
    alpha_cut = (1.0 - g) * state.alpha + g

    t_alpha = state.t_alpha + dt
    t_rate = state.t_rate + dt
    bytes_ctr = state.bytes_ctr + sent_bytes
    if soft is not None:
        return _soft_dcqcn(state, cnp, cfg, rtt_scale, soft, rc_cut, rt_cut,
                           alpha_cut, t_alpha, t_rate, bytes_ctr)

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
        rc=clip(rc, rmin),
        rt=rt,
        alpha=clip(alpha, 0.0, 1.0),
        t_alpha=torch.where(cut, 0.0, t_alpha_no),
        t_rate=torch.where(cut | fire, 0.0, t_rate),
        bytes_ctr=torch.where(cut | byte_fire, 0.0, bytes_ctr),
        stage_t=torch.where(cut, 0.0, stage_t),
        stage_b=torch.where(cut, 0.0, stage_b),
    )


def _soft_dcqcn(state: DcqcnState, cnp, cfg, rtt_scale, soft, rc_cut, rt_cut,
                alpha_cut, t_alpha, t_rate, bytes_ctr) -> DcqcnState:
    """The soft machine: CNPs are fractional, so the cut gate sits at the 0.5
    midpoint; timer, counter and stage resets take the detached gate (the
    timer phase is cadence structure, ``netsim.soft.reset_gate``)."""
    dt = cfg.dt_us
    g = cfg.dcqcn_g
    rai = cfg.dcqcn_rai_mbps * 1e6 / 8.0
    rhai = cfg.dcqcn_hai_mbps * 1e6 / 8.0
    rmin = cfg.min_rate_mbps * 1e6 / 8.0
    w_cut = soft_gt(cnp, 0.5, soft, 0.25)
    w_adec = soft_gt(t_alpha, cfg.dcqcn_alpha_timer_us, soft, dt)
    alpha_no = lerp(w_adec, (1.0 - g) * state.alpha, state.alpha)
    t_alpha_no = lerp(reset_gate(w_adec), 0.0, t_alpha)

    w_tfire = soft_gt(t_rate, cfg.dcqcn_rate_timer_us, soft, dt)
    w_bfire = soft_gt(bytes_ctr, cfg.dcqcn_bytes_counter_mb * 1e6, soft,
                      0.01 * cfg.dcqcn_bytes_counter_mb * 1e6)
    w_fire = soft_or(w_tfire, w_bfire)
    stage_t = state.stage_t + w_tfire
    stage_b = state.stage_b + w_bfire
    max_stage = torch.maximum(stage_t, stage_b)

    w_hyper = (soft_gt(stage_t, float(_F), soft, 0.5)
               * soft_gt(stage_b, float(_F), soft, 0.5))
    w_add = soft_gt(max_stage, float(_F), soft, 0.5) * (1.0 - w_hyper)
    inc = w_hyper * rhai + w_add * rai
    if rtt_scale is not None:
        inc = inc * rtt_scale
    rt_inc = lerp(w_fire, state.rt + inc, state.rt)
    rc_inc = lerp(w_fire, 0.5 * (state.rc + rt_inc), state.rc)

    rc = lerp(w_cut, rc_cut, rc_inc)
    rt = lerp(w_cut, rt_cut, rt_inc)
    alpha = lerp(w_cut, alpha_cut, alpha_no)
    w_cut_d = reset_gate(w_cut)
    return DcqcnState(
        rc=clip(rc, rmin),
        rt=rt,
        alpha=clip(alpha, 0.0, 1.0),
        t_alpha=lerp(w_cut_d, 0.0, t_alpha_no),
        t_rate=lerp(reset_gate(soft_or(w_cut, w_fire)), 0.0, t_rate),
        bytes_ctr=lerp(reset_gate(soft_or(w_cut, w_bfire)), 0.0, bytes_ctr),
        stage_t=lerp(w_cut_d, 0.0, stage_t),
        stage_b=lerp(w_cut_d, 0.0, stage_b),
    )


def themis_rtt_scale(rtt_us: torch.Tensor, rtt_ref_us: float = 10.0,
                     cap: float = 4.0) -> torch.Tensor:
    """RTT-aware fairness factor (sqrt-damped, clipped): long-haul flows
    increase faster / cut softer so short-loop flows cannot starve them."""
    return clip(torch.sqrt(rtt_us / rtt_ref_us), 1.0, cap)
