"""The shipped channel models: ideal, bernoulli_loss, jitter, otn_flap and
their composite ``impaired`` (the torch twin of the JAX package's
``netsim/channel/models.py``).

One implementation (``ImpairedChannel``) carries the three mechanisms behind
static flags; the registered names are instances with different flags.

  ``bernoulli_loss``  a per-flow Gilbert–Elliott chain whose Bad state drops
                      the step's arrivals: stationary loss ``loss_rate``,
                      mean Bad dwell ``loss_burst_len`` steps.
  ``jitter``          a random fraction of each step's arrivals is held back
                      in a per-flow deferral buffer (geometric holding, mean
                      extra delay ``jitter_us``).
  ``otn_flap``        every ``flap_period_us`` the line capacity drops by
                      ``flap_depth`` for ``FLAP_DUTY`` of the period, at a
                      per-scenario random phase.
  ``impaired``        all three.

Every draw is counter-based and bit-equal to the JAX package's: the step key
is ``fold_in(scenario_key(prng_key(channel_seed), params), t)`` (one more
``fold_in`` of the link index at L > 1), the loss and jitter draws use its
subkeys 0 and 1, derived in one call, and the flap phase is drawn once from
``fold_in(key, 0xF1A9)``. The soft engine (``soft_step``) keys from
``prng_key(channel_seed)`` alone, without the knob bits, so every knob value
sees the same noise; there the loss chain's comparisons and the flap dip are
tempered sigmoids (``netsim.soft``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.netsim.channel.base import (
    ChannelEffects, ChannelInputs, ChannelModel, per_link,
    register_channel_model,
)
from repro_torch.netsim.prng import f32_bits, fold_in, uniform
from repro_torch.netsim.soft import clip, lerp, soft_gt, soft_pos

# fraction of a flap period spent in the dip (the protection-switch hit)
FLAP_DUTY = 0.1
# subkey index of each draw under the step key (the JAX package's fold_in)
_LOSS, _JITTER = 0, 1
_FLAP_SALT = 0xF1A9


def scenario_key(key: torch.Tensor, params) -> torch.Tensor:
    """Fold the per-scenario knob bits into ``key`` one field at a time, as
    the JAX package does: scenarios with different knobs (or distances) draw
    decorrelated noise, identical ones the same, and knob values merely
    permuted across fields land on different streams. ``key`` is ``[2]``
    (or ``[B, 2]``), the result ``[B, 2]`` for ``[B]`` leaves."""
    for x in (params.loss_rate, params.loss_burst_len, params.jitter_us,
              params.flap_period_us, params.flap_depth,
              params.one_way_delay_us):
        key = fold_in(key, f32_bits(x))
    return key


class ImpairState(NamedTuple):
    """Private state of ``ImpairedChannel`` (disabled parts are ``None``)."""
    bad: Optional[torch.Tensor]     # [*lead, F] Gilbert–Elliott Bad state
    defer: Optional[torch.Tensor]   # [*lead, F] jitter-held bytes
    phase: Optional[torch.Tensor]   # [*lead] random flap phase in [0, 1)


@register_channel_model("ideal")
class IdealChannel(ChannelModel):
    """The long haul is a perfect pipe; the engine skips the channel
    machinery."""
    is_ideal = True


class ImpairedChannel(ChannelModel):
    """Gilbert–Elliott loss + stochastic jitter + OTN flap dips behind static
    enable flags (module docstring)."""

    is_ideal = False

    def __init__(self, loss: bool = True, jitter: bool = True,
                 flap: bool = True):
        self.loss, self.jitter, self.flap = bool(loss), bool(jitter), bool(flap)
        super().__init__()

    def init_channel_state(self, cfg, params, num_flows: int, key, link=None):
        z = torch.zeros(*key.shape[:-1], num_flows, device=key.device)
        phase = None
        if self.flap:
            phase = uniform(fold_in(key, _FLAP_SALT), ())   # once per run
        return ImpairState(bad=z if self.loss else None,
                           defer=z.clone() if self.jitter else None,
                           phase=phase)

    def apply_impairments(self, ctx, chan: ImpairState,
                          inp: ChannelInputs) -> ChannelEffects:
        p = ctx.params
        arrivals, cap_src = inp.pipe_out, inp.cap_src
        lost = torch.zeros_like(arrivals)
        bad, defer = chan.bad, chan.defer

        # the loss and jitter draws of this step from one pair of subkeys
        subs = [s for s, on in ((_LOSS, self.loss), (_JITTER, self.jitter)) if on]
        if subs:
            # subkey indices made on the device (a captured step may not
            # copy from the host)
            sub = torch.arange(subs[0], subs[-1] + 1, device=arrivals.device)
            draws = uniform(fold_in(inp.key[..., None, :], sub),
                            arrivals.shape[-1:])               # [*lead, n, F]

        # Every impairment joins the dataflow through a where() whose clean
        # branch is the original tensor: at zero knobs the run is the ideal
        # one bit for bit.
        if self.loss:
            # Gilbert–Elliott: exit Bad w.p. 1/L, enter Bad so that the
            # stationary Bad fraction is loss_rate
            r = per_link(clip(p.loss_rate, 0.0, 0.5), cap_src)[..., None]
            p_exit = 1.0 / clip(per_link(p.loss_burst_len, cap_src),
                                1.0)[..., None]
            p_enter = clip(p_exit * r / clip(1.0 - r, 0.5), 0.0, 1.0)
            u = draws[..., subs.index(_LOSS), :]
            if ctx.soft is None:
                in_bad = torch.where(chan.bad > 0.5, u < 1.0 - p_exit,
                                     u < p_enter)
                bad = in_bad.to(torch.float32)
                lost = torch.where(in_bad, arrivals, 0.0)  # Bad drops the step
                arrivals = torch.where(in_bad, 0.0, arrivals)
            else:
                # the tempered chain: the draw-vs-probability comparisons
                # are sigmoids, blended by the previous fractional Bad weight
                bad = lerp(soft_gt(chan.bad, 0.5, ctx.soft, 0.25),
                           soft_gt(1.0 - p_exit, u, ctx.soft, 0.05),
                           soft_gt(p_enter, u, ctx.soft, 0.05))
                lost = bad * arrivals
                arrivals = (1.0 - bad) * arrivals

        if self.jitter:
            # geometric holding: E[extra delay] = p/(1-p) * dt = jitter_us
            jit = per_link(p.jitter_us, cap_src)[..., None]
            p_hold = jit / clip(jit + ctx.dt_us, 1.0)
            v = draws[..., subs.index(_JITTER), :]
            income = arrivals + chan.defer
            held = torch.where(p_hold > 0.0,
                               income * clip(2.0 * v * p_hold, 0.0, 0.95),
                               0.0)
            arrivals = torch.where(p_hold > 0.0, income - held, arrivals)
            defer = held

        if self.flap:
            # a FLAP_DUTY-long capacity cut every flap_period_us, at this
            # scenario's (link's) random phase
            period = per_link(p.flap_period_us, cap_src)
            pos = torch.fmod(inp.t.to(torch.float32) * ctx.dt_us
                             / clip(period, ctx.dt_us) + chan.phase, 1.0)
            dipped = cap_src * (1.0 - clip(per_link(p.flap_depth, cap_src),
                                           0.0, 1.0))
            if ctx.soft is None:
                in_dip = (pos < FLAP_DUTY) & (period > 0)
                cap_src = torch.where(in_dip, dipped, cap_src)
            else:
                # flap_depth's gradient flows through the blend; the dip's
                # phase keeps its jump in knob space (the mod)
                w_dip = (soft_gt(FLAP_DUTY, pos, ctx.soft, 0.05)
                         * soft_pos(period, ctx.soft, ctx.dt_us))
                cap_src = lerp(w_dip, dipped, cap_src)

        return ChannelEffects(arrivals=arrivals, lost=lost, cap_src=cap_src,
                              chan=ImpairState(bad=bad, defer=defer,
                                               phase=chan.phase))

    def held_bytes(self, chan: ImpairState):
        return chan.defer if self.jitter else 0.0


register_channel_model("bernoulli_loss",
                       ImpairedChannel(loss=True, jitter=False, flap=False))
register_channel_model("jitter",
                       ImpairedChannel(loss=False, jitter=True, flap=False))
register_channel_model("otn_flap",
                       ImpairedChannel(loss=False, jitter=False, flap=True))
register_channel_model("impaired", ImpairedChannel())
