"""The pluggable long-haul channel-model interface + registry (the torch twin
of the JAX package's ``netsim/channel/base.py``).

A channel model is what the inter-DC segment does to bytes in flight: loss,
delay jitter, capacity dips. ``fluid.make_step_fn`` has one channel hook
point, between the pipe exit and the destination OTN, plus a capacity tap on
the source-OTN line; everything model-specific lives in a ``ChannelModel``
subclass registered under a name and reached through the ``channel=``
argument of every entry point.

Division of labour:
  * the MODEL owns the impairment draw (which bytes drop or are held back,
    how much line capacity survives) and its private state ``SimState.chan``;
    randomness is counter-based (``netsim.prng``, bit-equal to
    ``jax.random``), so runs are deterministic, resumable and share one
    noise realization across schemes;
  * the ENGINE owns reliability accounting: lost bytes ride a notification
    ring back to the source (delay D), wait in a per-flow retransmit backlog
    and re-enter the source OTN at the rate the scheme's ``retx_rate``
    grants; it emits the ``chan_*`` trace keys the metric hooks reduce.

Shapes: the hooks see the link axis as a batch axis. One link: per-link
quantities are ``[B]`` (``cap_src``) and per-flow ones ``[B, F]``; at
``num_paths = L > 1`` they are ``[B, L]`` and ``[B, L, F]``, each link with
its own key and state. ``per_link`` lays a per-scenario ``[B]`` knob out
against the per-link shape. Nothing in a per-step hook may read a value back
to the host (the step is captured in a CUDA graph on the card).

Hooks:
  ``init_channel_state``  private state carried in ``SimState.chan``.
  ``apply_impairments``   the per-step transform of the bytes leaving the
                          pipe and of the source-OTN capacity.
  ``held_bytes``          ``[..., F]`` bytes held between pipe and
                          destination OTN, folded into the conservation
                          residual.
  ``init_metric_acc`` / ``accumulate_metrics`` / ``finalize_metrics``
                          the streamed channel columns (``goodput_gbps``,
                          ``wire_gbps``, ``retx_frac``,
                          ``p99_repair_latency_us``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.netsim.streaming import (
    HIST_BINS, hist_bin_index, hist_quantile, kahan_add,
)


class ChannelInputs(NamedTuple):
    """What the step skeleton hands ``apply_impairments`` each step."""
    t: torch.Tensor          # step index (int32, 0-d, on the device)
    key: Optional[torch.Tensor]  # [*lead, 2] this step's PRNG key per link
                                 # (None for a model with needs_key False)
    pipe_out: torch.Tensor   # [*lead, F] bytes leaving the long-haul pipe
    cap_src: torch.Tensor    # [*lead] source-OTN line capacity this step
                             # (bytes; already zeroed while PFC pauses it)


class ChannelEffects(NamedTuple):
    """What ``apply_impairments`` returns to the skeleton."""
    arrivals: torch.Tensor   # [*lead, F] bytes entering the destination OTN
    lost: torch.Tensor       # [*lead, F] bytes dropped (to the repair path)
    cap_src: torch.Tensor    # [*lead] possibly dimmed source-OTN capacity
    chan: object             # the model's updated private state


def per_link(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-scenario ``[B]`` tensor laid out against the per-link shape of
    ``like`` (``[B]`` on one link, ``[B, L]`` on several): ``[B]`` or
    ``[B, 1]``."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


class ChannelModel:
    """Default hooks = the ideal channel (everything passes through).

    A subclass that impairs sets ``is_ideal = False``: the engine skips all
    channel machinery (PRNG, retransmit backlog, ``chan_*`` keys) for an
    ideal model. ``needs_key = False`` spares the per-step key derivation of
    a model that draws nothing (the engine passes ``key=None``)."""

    name: Optional[str] = None
    is_ideal: bool = True
    needs_key: bool = True

    def __init__(self):
        if self.name is None:
            self.name = type(self).__name__

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), self.name))

    # -- construction-time hook --------------------------------------------
    def init_channel_state(self, cfg, params, num_flows: int,
                           key: torch.Tensor, link=None):
        """Private state carried in ``SimState.chan`` (None = stateless).
        ``key`` is the run's base key per link, ``[*lead, 2]``: draw
        per-run randomness (flap phases) from it. ``link`` is None on one
        link, else the ``[L]`` link indices the leading ``L`` axis holds."""
        return None

    # -- per-step hooks ----------------------------------------------------
    def apply_impairments(self, ctx, chan, inp: ChannelInputs) -> ChannelEffects:
        """The per-step transform of the long haul. Default: the perfect
        pipe. ``ctx`` is the run's ``SchemeCtx`` (the knobs are on
        ``ctx.params``)."""
        return ChannelEffects(arrivals=inp.pipe_out,
                              lost=torch.zeros_like(inp.pipe_out),
                              cap_src=inp.cap_src, chan=chan)

    def held_bytes(self, chan):
        """``[*lead, F]`` bytes held between pipe and destination OTN (0.0
        when the model holds none)."""
        return 0.0

    # -- streaming-metric hooks (trace_mode="metrics") ---------------------
    def init_metric_acc(self, ctx, state) -> dict:
        """Kahan sums of wire / lost / retransmitted bytes and a
        log-histogram of the per-step repair-wait estimate, per scenario."""
        z = torch.zeros_like(state.sent[..., 0])
        return {"wire_s": z, "wire_c": z.clone(), "lost_s": z.clone(),
                "lost_c": z.clone(), "retx_s": z.clone(), "retx_c": z.clone(),
                "repair_hist": torch.zeros(z.shape + (HIST_BINS,),
                                           dtype=torch.int32, device=z.device)}

    def accumulate_metrics(self, ctx, acc: dict, state, out: dict, inc) -> dict:
        """Fold one step in (``inc``: 1.0 past the warm-up cutoff). A
        repair-wait sample counts only where a repair is pending
        (``chan_repair_wait_us > 0``); the histogram is updated in place."""
        acc = dict(acc)
        for k, key in (("wire", "chan_wire"), ("lost", "chan_lost"),
                       ("retx", "chan_retx")):
            acc[k + "_s"], acc[k + "_c"] = kahan_add(
                acc[k + "_s"], acc[k + "_c"], out[key] * inc)
        wait = out["chan_repair_wait_us"]
        b = hist_bin_index(wait)[..., None]
        acc["repair_hist"].scatter_add_(
            -1, b, (inc * (wait > 0)).to(torch.int32)[..., None])
        return acc

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int,
                         dt_s: float) -> dict:
        """Host side: numpy accumulators (``[B]``-leading) -> the channel
        columns of every sweep row."""
        wire = np.asarray(acc["wire_s"], np.float64)
        lost = np.asarray(acc["lost_s"], np.float64)
        retx = np.asarray(acc["retx_s"], np.float64)
        per_s = 1.0 / (max(n_warm, 1) * dt_s)
        return {
            "goodput_gbps": (wire - lost) * per_s * 8.0 / 1e9,
            "wire_gbps": wire * per_s * 8.0 / 1e9,
            "retx_frac": retx / np.maximum(wire, 1.0),
            "p99_repair_latency_us": hist_quantile(acc["repair_hist"], 0.99),
        }

    def __repr__(self):
        return f"<ChannelModel {self.name or type(self).__name__}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ChannelModel] = {}

ChannelLike = Union[str, ChannelModel, None]


def register_channel_model(name: str, model=None, *, override: bool = False):
    """Register a ``ChannelModel`` subclass (or instance) under ``name``;
    usable as a decorator. Re-registering a taken name raises unless
    ``override=True``."""
    def _register(obj):
        inst = obj() if isinstance(obj, type) else obj
        if not isinstance(inst, ChannelModel):
            raise TypeError(
                f"register_channel_model({name!r}): expected a ChannelModel "
                f"subclass or instance, got {type(inst).__name__}")
        if not override and name in _REGISTRY:
            raise ValueError(
                f"channel model {name!r} is already registered "
                f"({_REGISTRY[name]!r}); pass override=True to replace it")
        inst.name = name
        _REGISTRY[name] = inst
        return obj

    if model is None:
        return _register
    _register(model)
    return _REGISTRY[name]


def unregister_channel_model(name: str) -> None:
    """Remove a registered channel model (mainly for tests)."""
    _REGISTRY.pop(name, None)


def get_channel_model(channel: ChannelLike) -> ChannelModel:
    """Resolve a channel-model name (``None`` = ``"ideal"``; instances pass
    through)."""
    if channel is None:
        channel = "ideal"
    if isinstance(channel, ChannelModel):
        return channel
    try:
        return _REGISTRY[channel]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown channel model {channel!r}; registered: "
            f"{', '.join(available_channel_models()) or '(none)'}") from None


def available_channel_models() -> tuple:
    """Names of every registered channel model, sorted."""
    return tuple(sorted(_REGISTRY))
