"""The pluggable ``Scheme`` interface + registry of the port's fluid engine.

A scheme is how a long-haul RDMA control plane sees ACKs, shapes the
source-OTN release and routes congestion feedback. ``fluid.make_step_fn`` is
a scheme-agnostic skeleton (flow phase -> queues -> ECN/PFC -> CC -> FCT)
that composes the hooks below; the contract is the JAX package's
(``docs/scheme-api.md``): ``retx_rate`` grants the engine's loss-repair path
its rate, ``SchemeSignals.retx_arr`` carries the loss notifications that
arrive at the source, and with a failure schedule ``SchemeCtx.link_live``
holds the step's live-link mask, and ``emit_events`` adds a scheme's
candidates to the event ring of ``trace_mode="window"``.

Hooks run on torch tensors with a leading scenario axis ``[B]`` (per-flow
tensors ``[B, F]``); none may read a value back to the host, so a block of
steps can be captured in a CUDA graph.

  ``init_extra_state``   scheme-private state carried in ``SimState.extra``
                         (default: the MatchRDMA block, so every scheme has
                         the budget traces).
  ``ack_view``           cumulative acked bytes the sender sees (inter-DC).
  ``sender_rate``        sender rate law before NIC-PFC gating.
  ``src_otn_release``    how the source OTN drains toward the long haul.
  ``route_weights``      ``[B, F, L]`` spray weights over the parallel
                         long-haul links (``num_paths > 1`` only).
  ``retx_rate``          bytes/s granted to loss repair (channel path).
  ``feedback``           CNP routing + per-step updates of the extra state.
  ``rtt_scale``          optional per-flow DCQCN fairness factor (THEMIS).
  ``extra_traces``       scheme-owned additions to the per-step trace dict.
  ``emit_events``        scheme-owned event-ring candidates (window mode).
  ``init_metric_acc`` / ``accumulate_metrics`` / ``finalize_metrics``
                         streamed columns under ``trace_mode="metrics"``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.config.net import NetParams
from repro_torch.core.matchrdma import MatchRdmaState, init_matchrdma
from repro_torch.netsim.queues import drain_proportional


def long_haul_bdp(ctx: "SchemeCtx") -> torch.Tensor:
    """Long-haul bandwidth-delay product in bytes (2D x C_otn)."""
    return ctx.c_otn * 2.0 * ctx.params.one_way_delay_us * 1e-6


def apply_link_live(ctx: "SchemeCtx", weights: torch.Tensor) -> torch.Tensor:
    """Mask ``[B, F, L]`` spray weights down to the links alive this step:
    the reroute contract every ``route_weights`` honours. With no failure
    schedule (``ctx.link_live is None``) the weights pass through untouched."""
    if ctx.link_live is None:
        return weights
    live = ctx.link_live[..., None, :]
    return torch.where(live < 1.0, weights * live, weights)


class SchemeCtx(NamedTuple):
    """Per-run quantities shared by every hook, built once by
    ``make_step_fn``. Per-scenario tensors are ``[B]``, per-flow ``[B, F]``."""
    cfg: object                  # NetConfig: static structure
    params: NetParams            # per-scenario scalars, [B] leaves
    period_slots: int            # static estimator periodicity hint
    dt_us: float                 # static step length
    dt_s: float
    nic: torch.Tensor            # sender NIC rate, bytes/s
    c_otn: torch.Tensor          # OTN line capacity, bytes/s
    c_leaf: torch.Tensor         # destination leaf capacity, bytes/s
    xoff: torch.Tensor           # DC-leaf PFC pause threshold, bytes
    xon: torch.Tensor
    xoff_otn: torch.Tensor       # OTN PFC threshold (BDP-scaled), bytes
    xon_otn: torch.Tensor
    is_inter: torch.Tensor       # [B, F] 1.0 for inter-DC flows
    is_intra: torch.Tensor       # [B, F]
    rtt_us: torch.Tensor         # [B, F] e2e RTT estimate per flow
    d_steps: torch.Tensor        # [B] int32 one-way delay in steps
    # multi-link topology (num_paths > 1 only; None on the single pipe)
    num_links: int = 1                            # static L
    link_caps: Optional[torch.Tensor] = None      # [B, L] per-link bytes/s
    link_d_steps: Optional[torch.Tensor] = None   # [B, L] int32 delay steps
    # multi-site graph views (cfg.is_multisite only)
    num_sites: int = 2                            # static site count
    edge_sites: Optional[torch.Tensor] = None     # [L, 2] int32 site pairs
    flow_src_site: Optional[torch.Tensor] = None  # [B, F] flow source site
    flow_dst_site: Optional[torch.Tensor] = None  # [B, F] flow dest site
    # per-step live-link mask of a failure schedule ([B, L], 1.0 = up), set
    # by the engine each step; None without a schedule. route_weights folds
    # it in through apply_link_live so sprays avoid dead links
    link_live: Optional[torch.Tensor] = None
    # the soft-step temperature ([B] params.soft_temp) with cfg.soft_step,
    # else None: hooks thread it into their knob-dependent gates (tempered
    # sigmoids for hard selects, netsim.soft); None keeps every hard hook
    soft: Optional[torch.Tensor] = None
    # soft runs only: each scenario's steps per slot, host ints read once when
    # the step is built, so the eager soft step finds the slot boundaries of
    # its host step index with no device read
    slot_steps: Optional[tuple] = None


class SchemeSignals(NamedTuple):
    """Everything the datapath computed this step that feedback may need."""
    t: torch.Tensor              # step index (int32, 0-d)
    active: torch.Tensor         # [B, F] flow-phase activity mask
    sent: torch.Tensor           # [B, F] NEW cumulative bytes sent
    cnp_out: torch.Tensor        # [B, F] CNPs generated at the receiver
    cnp_arr: torch.Tensor        # [B, F] CNPs arriving after the return delay
    egress_bytes: torch.Tensor   # [B] bytes the dst OTN forwarded
    q_dst_tot: torch.Tensor      # [B] new dst-OTN backlog
    q_leaf: torch.Tensor         # [B, F] new dst-leaf queue
    leaf_pfc: torch.Tensor       # [B] leaf asserting PFC toward dst OTN
    retx_arr: torch.Tensor       # [B, F] loss notifications arriving at the
                                 # source (zeros without the repair path)
    retx_backlog: torch.Tensor   # [B, F] retransmit backlog after this
                                 # step's repair service
    # multi-link signals (None on the single pipe)
    link_sent: Optional[torch.Tensor] = None      # [B, L, F] sprayed per link
    link_arrivals: Optional[torch.Tensor] = None  # [B, L, F] landed per link
    link_want: Optional[torch.Tensor] = None      # [B, L] pre-clip demand
    link_cap: Optional[torch.Tensor] = None       # [B, L] capacity, bytes
    host_t: Optional[int] = None  # t on the host: eager soft runs only


class Feedback(NamedTuple):
    """What ``feedback`` hands back to the skeleton."""
    cnp_wire: torch.Tensor       # [B, F] value written on the CNP return line
    cnp_in: torch.Tensor         # [B, F] CNPs fed to the sender CC this step
    proxy_timer: torch.Tensor    # [B, F]
    proxy_mod: torch.Tensor      # [B, F]
    extra: object                # the scheme's updated extra state


class Scheme:
    """Default hooks = conventional end-to-end RDMA (DCQCN at the sender)."""

    name: Optional[str] = None

    def __init__(self):
        if self.name is None:
            self.name = type(self).__name__

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), self.name))

    # -- construction-time hooks -------------------------------------------
    def init_extra_state(self, cfg, params: NetParams, num_flows: int, *,
                         history_slots: int = 0, chan_delay_pad: int = 0):
        """Scheme-private state carried in ``SimState.extra``; the default
        is the full MatchRDMA block so the budget traces exist for every
        scheme."""
        return init_matchrdma(cfg, num_flows, history_slots=history_slots,
                              params=params, chan_delay_pad=chan_delay_pad)

    def rtt_scale(self, ctx: SchemeCtx):
        """Optional [B, F] DCQCN increase/cut fairness factor (None = 1)."""
        return None

    # -- per-step hooks ----------------------------------------------------
    def ack_view(self, ctx: SchemeCtx, state, ack_arr):
        """Cumulative acked bytes as the sender sees them (inter-DC flows):
        conventional ACKs returning over the full path."""
        return state.acked + ack_arr

    def sender_rate(self, ctx: SchemeCtx, state, base_rate):
        """Sender rate law: window limit and the sender's DCQCN rate."""
        return torch.minimum(state.cc.rc, base_rate)

    def src_otn_release(self, ctx: SchemeCtx, state, arrivals, cap, active):
        """Drain law of the source OTN: ``(new_q_src, drained)``, FIFO-fair."""
        return drain_proportional(state.q_src, arrivals, cap)

    def route_weights(self, ctx: SchemeCtx, state, base_route):
        """``[B, F, L]`` spray weights over the parallel links (the engine
        normalises rows and masks links without capacity): the workload's
        routing matrix, off dead links."""
        return apply_link_live(ctx, base_route)

    def retx_rate(self, ctx: SchemeCtx, state, rate):
        """``[B, F]`` bytes/s the sender may spend on repair: by default the
        scheme's own sender rate, so repair competes with new data."""
        return rate

    def feedback(self, ctx: SchemeCtx, state, sig: SchemeSignals) -> Feedback:
        """CNPs ride the full return path; intra-DC CNPs loop locally."""
        return Feedback(
            cnp_wire=sig.cnp_out * ctx.is_inter,
            cnp_in=torch.where(ctx.is_inter > 0, sig.cnp_arr,
                               sig.cnp_out * ctx.is_intra),
            proxy_timer=state.proxy_timer,
            proxy_mod=state.proxy_mod,
            extra=state.extra,
        )

    def extra_traces(self, ctx: SchemeCtx, state) -> dict:
        """Scheme-owned per-step trace entries (from the PRE-step state)."""
        if isinstance(state.extra, MatchRdmaState):
            return {"budget": state.extra.budget.budget,
                    "budget_at_src": state.extra.budget_at_src}
        return {}

    def emit_events(self, ctx: SchemeCtx, prev_state, state, out: dict) -> tuple:
        """Scheme-owned event-ring candidates, evaluated around each step
        (``prev_state`` / ``state`` are the pre / post ``SimState``) only
        under ``trace_mode="window"`` with ``NetConfig.event_ring_slots >
        0``. Returns a tuple of ``(kind_name, obj, value, fired)``:
        ``kind_name`` a key of ``repro_torch.netsim.obs.EVENT_KINDS``,
        ``obj`` a static int, ``value`` a ``[B]`` payload and ``fired`` a
        ``[B]`` bool predicate. The candidate count must be static.
        Default: no scheme events."""
        return ()

    # -- streaming-metric hooks (trace_mode="metrics") ---------------------
    def init_metric_acc(self, ctx: SchemeCtx, state) -> dict:
        """Scheme-private streamed sums (a dict, so subclasses merge
        ``super()``'s entries): the destination budget's warm-step sum."""
        if isinstance(state.extra, MatchRdmaState):
            return {"budget_sum": torch.zeros_like(state.extra.budget.budget)}
        return {}

    def accumulate_metrics(self, ctx: SchemeCtx, acc: dict, state, out: dict,
                           inc) -> dict:
        """Fold one step in: ``state`` is the post-step state, ``inc`` 1.0
        on steps past the warm-up cutoff."""
        if "budget_sum" in acc:
            acc = dict(acc, budget_sum=acc["budget_sum"]
                       + state.extra.budget.budget * inc)
        return acc

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int) -> dict:
        """Host-side: numpy accumulators ([B]-leading) -> metric columns."""
        if "budget_sum" in acc:
            return {"mean_budget_gbps": np.asarray(acc["budget_sum"])
                    / max(n_warm, 1) * 8.0 / 1e9}
        return {}

    def __repr__(self):
        return f"<Scheme {self.name or type(self).__name__}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Scheme] = {}

SchemeLike = Union[str, Scheme]


def register_scheme(name: str, scheme=None, *, override: bool = False):
    """Register a ``Scheme`` subclass (or instance) under ``name``; usable as
    a decorator. Re-registering a taken name raises unless ``override``."""
    def _register(obj):
        inst = obj() if isinstance(obj, type) else obj
        if not isinstance(inst, Scheme):
            raise TypeError(
                f"register_scheme({name!r}): expected a Scheme subclass or "
                f"instance, got {type(inst).__name__}")
        if not override and name in _REGISTRY:
            raise ValueError(
                f"scheme {name!r} is already registered "
                f"({_REGISTRY[name]!r}); pass override=True to replace it")
        inst.name = name
        _REGISTRY[name] = inst
        return obj

    if scheme is None:
        return _register
    _register(scheme)
    return _REGISTRY[name]


def unregister_scheme(name: str) -> None:
    """Remove a registered scheme (mainly for tests)."""
    _REGISTRY.pop(name, None)


def get_scheme(scheme: SchemeLike) -> Scheme:
    """Resolve a scheme name (or pass a ``Scheme`` instance through)."""
    if isinstance(scheme, Scheme):
        return scheme
    try:
        return _REGISTRY[scheme]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown scheme {scheme!r}; registered: "
            f"{', '.join(available_schemes()) or '(none)'}") from None


def available_schemes() -> tuple:
    """Names of every registered scheme, sorted."""
    return tuple(sorted(_REGISTRY))
