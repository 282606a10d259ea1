"""Fluid-flow discrete-time simulator of the dual AI-DC leaf-spine-OTN path.

The PyTorch twin of the JAX package's ``netsim/fluid.py`` on the paper's
Fig. 3 path: one step = ``dt_us`` of simulated time; per-flow byte rates are
integrated through the queues of Fig. 3(a):

    sender NIC --> [Q_src] source OTN --(pipe: delay D, cap C_otn)-->
    [Q_dst] destination OTN --> [Q_leaf] destination leaf (shared with
    intra-DC flows, ECN marking here) --> receiver

with ACKs and CNPs returning over delay lines of D (or consumed on the way,
as the scheme decides) and PFC from the destination OTN riding back over D.

What the port runs: one long-haul link or ``num_paths`` parallel links
(``[L]``, optionally the edges of a site graph), every registered channel
model (``channel=``), failure schedules, the hard step and the soft
(differentiable) one, and ``trace_mode`` ``full``, ``decimate``,
``metrics`` and ``window``.

Soft step (``cfg.soft_step``): every knob-dependent hard select becomes a
blend tempered by the per-scenario ``soft_temp`` leaf (``netsim.soft``), so
``torch.autograd`` differentiates a run's streamed sums with respect to any
float leaf of ``NetParams`` and ``WorkloadParams`` (``run_traced_batch``);
the completion latch stays hard. The soft step writes every ring into a new
tensor (autograd records the writes), keys the channel from
``prng_key(channel_seed)`` without the knob bits (the same noise for every
knob value: the common random numbers a gradient needs) and runs eagerly on
the card too. ``cfg.remat_steps = k > 1`` checkpoints each block of k steps
of a metrics run (``torch.utils.checkpoint``), so a backward holds the
tensors of one block and the block boundaries instead of every step's.

``window`` mode is ``metrics`` (the same streamed ``MetricAcc``, bit for
bit) plus a ring of the last ``cfg.trace_window_steps`` steps of every trace
key (step t in row ``t mod W``) and, when ``cfg.event_ring_slots > 0``, the
event ring of ``netsim.obs`` pushed after each step from the carry before
the step and the state after it (``WindowAux``).

Channel and failures: a non-ideal channel model impairs what leaves the pipe
before the destination OTN sees it and may dim the source-OTN capacity; its
draws are counter-based (``netsim.prng``, bit-equal to ``jax.random``) with
the step key ``fold_in(scenario_key(prng_key(channel_seed), params), t)``
folded from the device-side ``t`` (one more ``fold_in`` of the link index
at L > 1). A failure schedule marks links dead in its windows: their
capacity is zeroed and what reaches their far end is dumped. Either switches
on the loss-repair path: lost bytes ride a notification ring back to the
source (delay D), wait in a per-flow retransmit backlog and re-enter the
source OTN at the scheme's ``retx_rate``, ahead of new data. Every
impairment joins through a ``where`` whose clean branch is the original
tensor, so zero knobs and an all-up schedule are the ideal run bit for bit.
Soft-mode runs take the noise stream of ``prng_key(channel_seed)`` itself.

Multi-link (``cfg.num_paths = L > 1``): the source OTN's release is sprayed
over the links by the scheme's ``route_weights`` (masked to links with
capacity, rows normalised, clipped per link; what a link cannot take spills
back into the source queue). Each link has its own capacity, delay and
destination PFC threshold, and its own pause riding back at its own delay.
On a site graph each flow sprays only onto the edges of its site pair.

Batching: every state leaf carries the JAX package's vmapped shape, a
leading scenario axis ``[B]`` (per-flow ``[B, F]``, delay rings
``[B, Dp, F]``; at L > 1 ``q_dst [B, L, F]``, ``pipe [B, Dp, L, F]``,
``pause_line [B, Dp, L]``, ``pause_dst [B, L]``; with the repair path
``retx_backlog [B, F]``, ``retx_line [B, Dp, F]``, ``retx_inflight [B, F]``),
and one step advances the whole batch. Rings are allocated at the batch's
padded length ``delay_pad`` and each scenario's (each link's) ring index
wraps at its own delay. The hard step writes the
delay rings (the notification ring too), the control subchannel and the
metrics histograms in place; everything else a step makes is new.

Execution: on the CPU the steps run eagerly. On the card ``simulate_batch``
captures a block of hard steps into a ``torch.cuda.CUDAGraph`` and replays it:
the state lives in static tensors, the step index ``t`` is a device int32
advanced inside the graph, and no step reads a value back to the host (the
counterpart of JAX's one compiled ``lax.scan``). A capture that fails
raises.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.net import (
    NetConfig, NetParams, batch_template, stack_net_params,
)
from repro_torch.core.cc_proxy import DcqcnState, init_dcqcn, step_dcqcn
from repro_torch.core.matchrdma import default_history_slots
from repro_torch.device import resolve_device
from repro_torch.netsim.channel import (
    ChannelInputs, get_channel_model, scenario_key,
)
from repro_torch.netsim.obs.events import (
    EventRing, candidate_codes, engine_event_candidates, init_event_ring,
    push_events,
)
from repro_torch.netsim.prng import fold_in, prng_key
from repro_torch.netsim.queues import (
    drain_proportional, ecn_mark_prob, pfc_hysteresis,
)
from repro_torch.netsim.schemes import get_scheme
from repro_torch.netsim.schemes.base import Scheme, SchemeCtx, SchemeSignals
from repro_torch.netsim.soft import (
    clip, lerp, magnitude, reset_gate, soft_gt, soft_pos, ste,
)
from repro_torch.netsim.streaming import HIST_BINS, hist_bin_index, kahan_add
from repro_torch.netsim.topology import validate_site_endpoints
from repro_torch.netsim.workload import WorkloadParams, as_workload_batch

MTU = 1500.0
INF = float(np.float32(1e30))
WARMUP_FRAC = 0.1   # fraction of the horizon discarded as startup transient

TRACE_MODES = ("full", "decimate", "metrics", "window")

# engine-owned streaming reductions: warm-step sums (-> means) and all-step
# running maxes. ``MetricAcc`` keeps them as columns in this order.
STREAM_SUM_KEYS = ("q_src", "q_dst", "q_leaf", "pause_dst",
                   "thr_inter", "thr_intra")
STREAM_MAX_KEYS = ("q_src", "q_dst", "q_leaf", "cons_err")
# Trace keys that are per-step byte counts: under ``trace_mode="decimate"``
# a kept row holds the SUM over its block (level keys keep the block's last
# step), so the channel's rate columns are exact at any decimation.
DECIMATE_SUM_KEYS = ("chan_wire", "chan_lost", "chan_retx")

# Steps per captured CUDA graph on the card.
GRAPH_BLOCK = 256


def is_unfinished(done_at_us):
    """True where ``done_at_us`` still carries the INF 'not done' sentinel
    (any value at or above INF/2; numpy or torch)."""
    return done_at_us >= INF / 2


class MetricAcc(NamedTuple):
    """O(1)-per-scenario carry of the Fig. 3 reductions
    (``trace_mode="metrics"``). The JAX package keeps ``sum_s``, ``sum_c``
    and ``maxes`` as dicts of ``[B]`` arrays; here each is one tensor whose
    last axis follows ``STREAM_SUM_KEYS`` / ``STREAM_MAX_KEYS`` (one kernel
    a step updates them all; ``acc_columns`` gives the dict view)."""
    sum_s: torch.Tensor    # [B, 6] Kahan running sums over warm steps
    sum_c: torch.Tensor    # [B, 6] Kahan compensation terms
    maxes: torch.Tensor    # [B, 4] running maxes over ALL steps
    hist: torch.Tensor     # [B, HIST_BINS] int32 warm-step histogram of q_dst
    scheme: dict           # scheme-private accumulators (Scheme.init_metric_acc)
    chan: Optional[dict] = None   # channel accumulators (ChannelModel.
                                  # init_metric_acc; None without repair path)


class WindowAux(NamedTuple):
    """Aux output of ``trace_mode="window"``: everything ``metrics`` mode
    streams, plus the last ``cfg.trace_window_steps`` steps of every trace
    key and (optionally) the event ring; O(W + E) per scenario, never O(T).
    Every leaf has a leading ``[B]`` axis."""
    acc: MetricAcc                  # the same streamed reductions as "metrics"
    window: dict                    # trace key -> [B, W, ...] ring; step t
                                    # in row t mod W (obs.unroll_window
                                    # reorders)
    events: Optional[EventRing]     # with cfg.event_ring_slots > 0, else None


def acc_columns(acc: MetricAcc) -> dict:
    """``{"sum_s": {key: [B]}, "sum_c": ..., "maxes": ...}``: the JAX
    package's dict layout of the engine's streamed reductions."""
    return {name: {k: getattr(acc, name)[..., i] for i, k in enumerate(keys)}
            for name, keys in (("sum_s", STREAM_SUM_KEYS),
                               ("sum_c", STREAM_SUM_KEYS),
                               ("maxes", STREAM_MAX_KEYS))}


def _failure_len(params: NetParams) -> int:
    """Static outage-window count W of a run: the ``fail_windows`` leaf's
    shape (a batch template resets ``cfg.failure_schedule``)."""
    return int(params.fail_windows.shape[-2])


def _track_chan(channel, params: NetParams) -> bool:
    """Whether the loss-repair path (and its ``chan_*`` trace keys and
    streamed channel columns) exists: any non-ideal channel, or a failure
    schedule (an outage dumps bytes into the repair path even under the
    ideal channel)."""
    return (not channel.is_ideal) or _failure_len(params) > 0


def _init_metric_acc(scheme, channel, ctx, state0) -> MetricAcc:
    z = torch.zeros_like(state0.inflight[..., 0])
    return MetricAcc(
        sum_s=z[..., None].repeat_interleave(len(STREAM_SUM_KEYS), -1),
        sum_c=z[..., None].repeat_interleave(len(STREAM_SUM_KEYS), -1),
        maxes=z[..., None].repeat_interleave(len(STREAM_MAX_KEYS), -1),
        hist=torch.zeros(z.shape + (HIST_BINS,), dtype=torch.int32,
                         device=z.device),
        scheme=scheme.init_metric_acc(ctx, state0),
        chan=(channel.init_metric_acc(ctx, state0)
              if _track_chan(channel, ctx.params) else None),
    )


def _accumulate_engine(acc: MetricAcc, out: dict, inc,
                       inplace: bool = True) -> MetricAcc:
    """Fold one step's trace dict into the engine's streamed reductions
    (``inc``: 1.0 past the warm-up cutoff). The histogram is updated in
    place, or into a new tensor with ``inplace=False`` (the soft step's,
    whose blocks a checkpointed backward runs again)."""
    x = torch.stack([out[k] for k in STREAM_SUM_KEYS], -1) * inc
    # Kahan-compensated so the streamed mean matches the trace mean to ~ulp
    sum_s, sum_c = kahan_add(acc.sum_s, acc.sum_c, x)
    maxes = torch.maximum(acc.maxes,
                          torch.stack([out[k] for k in STREAM_MAX_KEYS], -1))
    b = hist_bin_index(out["q_dst"].detach())[..., None]
    ones = inc.to(torch.int32).expand(b.shape)
    if inplace:
        acc.hist.scatter_add_(-1, b, ones)
        return acc._replace(sum_s=sum_s, sum_c=sum_c, maxes=maxes)
    return acc._replace(sum_s=sum_s, sum_c=sum_c, maxes=maxes,
                        hist=acc.hist.scatter_add(-1, b, ones))


class SimState(NamedTuple):
    """The engine state; per-scenario leaves ``[B]``, per-flow ``[B, F]``,
    delay rings ``[B, Dp, F]`` (no leading axis for one unbatched scenario;
    the L > 1 shapes are in the module docstring). The channel slots are
    None exactly where the JAX package's are: ``chan`` under the ideal
    channel, ``retx_*`` without the repair path (ideal channel, no failure
    schedule)."""
    sent: torch.Tensor          # cumulative bytes leaving the sender NIC
    acked: torch.Tensor         # cumulative bytes ACKed at the sender
    delivered: torch.Tensor     # cumulative bytes delivered to the receiver
    done_at_us: torch.Tensor    # completion time (INF = not done)
    cc: DcqcnState              # DCQCN machine
    cnp_timer: torch.Tensor     # us since last CNP emission (receiver side)
    marked_acc: torch.Tensor    # marked-byte accumulator
    proxy_timer: torch.Tensor   # us since last proxy cut (MatchRDMA)
    proxy_mod: torch.Tensor     # multiplicative proxy modulation in [0.25, 1]
    q_src: torch.Tensor         # source-OTN queue bytes
    q_dst: torch.Tensor         # destination-OTN queue bytes (per link)
    q_leaf: torch.Tensor        # destination-leaf queue bytes
    pipe: torch.Tensor          # [.., Dp, (L,) F] in-flight long-haul bytes
    inflight: torch.Tensor      # running sum of pipe
    ack_line: torch.Tensor      # [.., Dp, F] ACK return path
    cnp_line: torch.Tensor      # [.., Dp, F] CNP return path
    pause_line: torch.Tensor    # [.., Dp, (L)] PFC signal dst-OTN -> src-OTN
    pause_dst: torch.Tensor     # dst OTN asserting long-haul pause (per link)
    extra: object               # scheme-private state (Scheme.init_extra_state)
    chan: object = None         # channel-private state (init_channel_state)
    retx_backlog: Optional[torch.Tensor] = None   # lost bytes awaiting repair
    retx_line: Optional[torch.Tensor] = None      # [.., Dp, F] notifications
    retx_inflight: Optional[torch.Tensor] = None  # running sum of retx_line


def check_main_path(channel=None, trace_mode: str = "full",
                    decimate: int = 1) -> None:
    """Raise ``ValueError`` for an unknown channel model or trace mode."""
    get_channel_model(channel)
    if trace_mode not in TRACE_MODES:
        raise ValueError(f"unknown trace_mode {trace_mode!r}; expected one of "
                         f"{TRACE_MODES}")
    if decimate < 1:
        raise ValueError(f"decimate must be >= 1, got {decimate}")


def init_state(cfg: NetConfig, num_flows: int, params: NetParams = None,
               delay_pad: int = 0, history_slots: int = 0,
               scheme: Scheme = None, channel=None) -> SimState:
    """The initial state. ``params`` carries the per-scenario scalars (their
    shape, 0-d or ``[B]``, is the state's leading shape; None = ``cfg``'s
    own); ``delay_pad``/``history_slots`` are ring sizes (0 = size for
    ``cfg``); ``scheme`` owns the ``extra`` slot (None = the default
    MatchRDMA block); ``channel`` (a registered name or model, None =
    ideal) owns ``chan``, and the ``retx_*`` slots exist with the repair
    path."""
    channel = get_channel_model(channel)
    f = num_flows
    n_links = cfg.num_paths
    links = (n_links,) if n_links > 1 else ()
    if delay_pad <= 0:
        delay_pad = cfg.static_delay_steps
    if params is None:
        params = NetParams.of(cfg)
    if scheme is None:
        scheme = Scheme()
    bs = params.one_way_delay_us.shape
    dev = params.one_way_delay_us.device

    def z(*shape):
        return torch.zeros(*bs, *shape, device=dev)

    chan = backlog = retx_line = retx_inflight = None
    if _track_chan(channel, params):
        backlog, retx_line, retx_inflight = z(f), z(delay_pad, f), z(f)
    if not channel.is_ideal:
        base_key = _channel_key(cfg, params, dev)
        if links:
            # one impairment process per link: the link index folded in
            link = torch.arange(n_links, device=dev)
            chan = channel.init_channel_state(
                cfg, params, f, key=fold_in(base_key[..., None, :], link),
                link=link)
        else:
            chan = channel.init_channel_state(cfg, params, f, key=base_key)
    nic = params.nic_gbps * 1e9 / 8.0
    return SimState(
        sent=z(f), acked=z(f), delivered=z(f),
        done_at_us=torch.full((*bs, f), INF, device=dev),
        cc=init_dcqcn(f, nic),
        cnp_timer=torch.full((*bs, f), 1e9, device=dev),
        marked_acc=z(f),
        proxy_timer=torch.full((*bs, f), 1e9, device=dev),
        proxy_mod=torch.ones(*bs, f, device=dev),
        q_src=z(f), q_dst=z(*links, f), q_leaf=z(f),
        pipe=z(delay_pad, *links, f),
        inflight=z(f),
        ack_line=z(delay_pad, f),
        cnp_line=z(delay_pad, f),
        pause_line=z(delay_pad, *links),
        pause_dst=z(*links),
        extra=scheme.init_extra_state(
            cfg, params, f, history_slots=history_slots,
            chan_delay_pad=delay_pad + cfg.control_proc_steps),
        chan=chan, retx_backlog=backlog, retx_line=retx_line,
        retx_inflight=retx_inflight,
    )


def _channel_key(cfg: NetConfig, params: NetParams, dev) -> torch.Tensor:
    """The run's ``[B, 2]`` channel key: the knob bits folded into
    ``prng_key(channel_seed)`` (``scenario_key``), or in soft mode that key
    itself for every scenario, so that a knob's perturbations share one
    noise stream (bit folding would redraw it, and has no gradient)."""
    key = prng_key(cfg.channel_seed, dev)
    if cfg.soft_step:
        return key.expand(*params.one_way_delay_us.shape, 2)
    return scenario_key(key, params)


def _write_row(ring: torch.Tensor, dim: int, index: torch.Tensor,
               src: torch.Tensor, inplace: bool) -> torch.Tensor:
    """``ring`` with ``src`` scattered at ``index`` along ``dim``: in place
    (the hard step's rings), or into a new tensor (the soft step's, which
    autograd records)."""
    if inplace:
        return ring.scatter_(dim, index, src)
    return ring.scatter(dim, index, src)


def ring_row(t: torch.Tensor, d_steps: torch.Tensor, delay_pad: int):
    """Row of the delay rings that step ``t`` reads and then writes: each
    scenario's ring wraps at its own delay, inside the padded allocation."""
    return torch.remainder(t, d_steps)


def link_ring_row(t: torch.Tensor, link_d_steps: torch.Tensor):
    """``[B, L]`` rows of the per-link rings (pipe, pause line) that step
    ``t`` reads and then writes: each link wraps at its own delay."""
    return torch.remainder(t, link_d_steps)


def _drain_links(q, arrivals, capacity_bytes):
    """``drain_proportional`` over every (link, flow) entry of ``[B, L, F]``
    queues at once, as the JAX package drains its ``[L, F]`` destination
    OTN: one capacity, shared in proportion to the whole backlog."""
    shape = q.shape
    new_q, drained = drain_proportional(q.flatten(-2), arrivals.flatten(-2),
                                        capacity_bytes)
    return new_q.view(shape), drained.view(shape)


def step_key(chan_key0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This step's channel key per scenario, ``fold_in(chan_key0, t)``: folded
    from the device-side step index, so every replay of a captured graph
    draws its own step's noise."""
    return fold_in(chan_key0, t)


def outage_dump(down: torch.Tensor, arrivals: torch.Tensor):
    """What reaches the far end of a dead link is lost there: ``(arrivals
    delivered, bytes dumped)`` under the dead mask ``down`` (broadcast
    against ``arrivals``)."""
    return torch.where(down, 0.0, arrivals), torch.where(down, arrivals, 0.0)


def notified_backlog(backlog: torch.Tensor, retx_arr: torch.Tensor) -> torch.Tensor:
    """The retransmit backlog at the source once this step's loss
    notifications have arrived."""
    return backlog + retx_arr


def _workload_tensors(wl, device) -> WorkloadParams:
    return WorkloadParams(*(torch.as_tensor(np.asarray(v, np.float32)
                                            if not torch.is_tensor(v) else v,
                                            device=device) for v in wl))


def make_step_fn(cfg: NetConfig, wl: WorkloadParams, scheme,
                 period_slots: int = 0, params: NetParams = None,
                 delay_pad: int = 0, channel=None):
    """Build the per-step transition ``step(state, t, host_t=None) -> (state,
    out)``; eager soft runs pass ``host_t``, ``t`` on the host.

    ``wl``: the per-flow workload leaves (numpy or tensors, the leading shape
    of ``params``'s leaves); ``params``: the per-scenario scalars (None =
    ``cfg``'s own); ``channel``: a registered channel-model name or model
    (None = ideal); ``t``: the step index, an int32 0-d tensor on the run's
    device. ``out`` is the step's trace dict (per-scenario values; at L > 1
    also the per-link ``q_dst_link``, ``link_tx`` and ``link_pause``; with
    the repair path the ``chan_*`` keys; with a failure schedule
    ``fail_live``)."""
    n_links = cfg.num_paths
    multi = n_links > 1
    if cfg.is_multisite and not multi:
        raise ValueError(
            f"make_step_fn: multi-site config (num_sites={cfg.num_sites}, "
            f"site_edges={cfg.site_edges!r}) requires num_paths > 1 - a "
            f"site graph compiles onto the link axis (one edge per link; "
            f"see docs/sites.md)")
    scheme = get_scheme(scheme)
    channel = get_channel_model(channel)
    impaired = not channel.is_ideal
    if params is None:
        params = NetParams.of(cfg)
    has_fail = _failure_len(params) > 0
    repair = impaired or has_fail
    if delay_pad <= 0:
        delay_pad = cfg.static_delay_steps
    dev = params.one_way_delay_us.device
    wl = _workload_tensors(wl, dev)
    dt_us = cfg.dt_us
    dt_s = dt_us * 1e-6
    # the soft step's temperature, [B] (None: the hard step)
    soft = params.soft_temp if cfg.soft_step else None
    inplace = soft is None
    # each scenario's delay, clamped to the ring allocation (an index past it
    # would raise, where JAX would clamp it silently)
    d_steps = torch.clamp(params.delay_steps(dt_us), 1, delay_pad)
    nic = params.nic_gbps * 1e9 / 8.0
    c_otn = params.otn_capacity_gbps * 1e9 / 8.0
    c_leaf = params.dst_dc_gbps * 1e9 / 8.0
    xoff = params.pfc_xoff_kb * 1024.0
    xon = params.pfc_xon_kb * 1024.0
    # OTN nodes are provisioned with BDP-scaled buffers (long-haul headroom)
    bdp = c_otn * 2.0 * params.one_way_delay_us * 1e-6
    xoff_otn = torch.maximum(xoff, params.otn_buffer_bdp_frac * bdp)
    xon_otn = xoff_otn / 2.0

    is_inter = wl.is_inter
    is_intra = 1.0 - is_inter
    inter = is_inter > 0
    window = wl.window
    total_bytes = wl.total_bytes
    start_us = wl.start_us
    active_mask = wl.active_mask
    f = is_inter.shape[-1]
    rtt_us = torch.where(inter, 2.0 * d_steps[..., None] * dt_us + 4.0, 4.0)
    # loop invariants of the step, computed once as XLA hoists them
    periodic = wl.period_us > 0
    period = clip(wl.period_us, 1.0)
    on_len = wl.duty * wl.period_us
    c_otn_dt = c_otn * dt_s
    c_leaf_dt = c_leaf * dt_s
    nic_col = nic[..., None]
    zero_f = torch.zeros_like(is_inter)       # no loss notifications

    link_caps = link_d_steps = edge_sites = None
    if multi:
        # per-link capacity, delay (clamped to the ring) and dst-OTN PFC
        # thresholds: the explicit floor or the link's own BDP-scaled
        # headroom, whichever is larger. Everything constant over the run
        # is built here, outside the captured step.
        link_caps = params.link_cap_gbps * 1e9 / 8.0              # [B, L]
        link_d_steps = torch.clamp(
            torch.round(params.link_delay_us / dt_us).to(torch.int32),
            1, delay_pad)                                         # [B, L]
        link_bdp = link_caps * 2.0 * params.link_delay_us * 1e-6
        xoff_link = torch.maximum(
            params.link_thresh_kb * 1024.0,
            params.otn_buffer_bdp_frac[..., None] * link_bdp)
        xon_link = xoff_link / 2.0
        link_caps_dt = link_caps * dt_s
        link_ids = torch.arange(n_links, device=dev)
        cap_w = link_caps / clip(link_caps.sum(-1, keepdim=True), 1e-9)
        route = wl.route                                          # [B, F, W]
        if route.shape[-1] == 1:
            route = route.expand(*route.shape[:-1], n_links)
        elif route.shape[-1] != n_links:
            raise ValueError(
                f"WorkloadParams.route has {route.shape[-1]} link columns "
                f"but cfg.num_paths = {n_links} - give each flow a "
                f"length-{n_links} route (or () for the symmetric default)")
        if cfg.is_multisite:
            # the endpoint matrix: each flow sprays only onto the edges
            # serving its (src_site, dst_site) pair
            edge_sites = torch.as_tensor(cfg.edge_pairs(), dtype=torch.int32,
                                         device=dev)              # [L, 2]
            pair_mask = ((wl.src_site[..., None] == edge_sites[:, 0])
                         & (wl.dst_site[..., None] == edge_sites[:, 1]))
            route = route * pair_mask.to(torch.float32)

    ctx = SchemeCtx(
        cfg=cfg, params=params, period_slots=period_slots,
        dt_us=dt_us, dt_s=dt_s, nic=nic, c_otn=c_otn, c_leaf=c_leaf,
        xoff=xoff, xon=xon, xoff_otn=xoff_otn, xon_otn=xon_otn,
        is_inter=is_inter, is_intra=is_intra, rtt_us=rtt_us, d_steps=d_steps,
        num_links=n_links, link_caps=link_caps, link_d_steps=link_d_steps,
        num_sites=cfg.num_sites, edge_sites=edge_sites,
        flow_src_site=wl.src_site if cfg.is_multisite else None,
        flow_dst_site=wl.dst_site if cfg.is_multisite else None, soft=soft,
        slot_steps=None if soft is None else tuple(torch.clamp(torch.round(
            params.slot_us.detach() / dt_us).to(torch.int32), min=1).tolist()))
    rtt_scale = scheme.rtt_scale(ctx)
    keyed = impaired and channel.needs_key
    if keyed:
        # the per-scenario stream, built once outside the captured step
        chan_key0 = _channel_key(cfg, params, dev)
    if has_fail:
        fail_lo = params.fail_windows[..., 0]                     # [B, L, W]
        fail_hi = params.fail_windows[..., 1]
    if repair:
        d_us = d_steps.to(torch.float32) * dt_us

    def step(state: SimState, t: torch.Tensor, host_t: Optional[int] = None):
        t_us = t.to(torch.float32) * dt_us
        row = ring_row(t, d_steps, delay_pad).to(torch.int64)[..., None]
        row_f = row[..., None].expand(*row.shape[:-1], 1, f)

        # ------------------------------------------- 0. failure live mask
        # a link is down inside any of its (down, up) windows (strict upper
        # bound: the (0, 0) padding windows never fire); schemes see the
        # mask and re-spray over the survivors
        if has_fail:
            link_down = ((t_us >= fail_lo) & (t_us < fail_hi)).any(-1)  # [B, L]
            link_live = 1.0 - link_down.to(torch.float32)
            hctx = ctx._replace(link_live=link_live)
        else:
            hctx = ctx

        # ------------------------------------------------ 1. flow phase
        if soft is None:
            started = (t_us >= start_us).to(torch.float32)
            in_period = torch.where(
                periodic,
                (torch.fmod(torch.clamp(t_us - start_us, min=0.0), period)
                 < on_len).to(torch.float32),
                1.0)
            not_done = (state.delivered < total_bytes).to(torch.float32)
        else:
            started = soft_gt(t_us, start_us, soft, dt_us)
            phase = torch.fmod(clip(t_us - start_us, 0.0), period)
            in_period = lerp(soft_pos(wl.period_us, soft, dt_us),
                             soft_gt(on_len, phase, soft, dt_us), 1.0)
            # straight-through on the activity gate: forward the exact live
            # mask (consistent with the hard completion latch), backward the
            # tempered one
            not_done = ste(
                (state.delivered < total_bytes).to(torch.float32),
                soft_gt(total_bytes, state.delivered, soft,
                        clip(1e-3 * total_bytes, MTU)))
        active = started * in_period * not_done * active_mask

        # ------------------------------------------------ 2. delayed inputs
        ack_arr = state.ack_line.gather(-2, row_f)[..., 0, :]
        cnp_arr = state.cnp_line.gather(-2, row_f)[..., 0, :]
        if multi:
            # each link's ring row wraps at its own delay: row l of the
            # padded ring holds what link l launched d_l steps ago
            lrow = link_ring_row(t, link_d_steps).to(torch.int64)[..., None, :]
            lrow_f = lrow[..., None].expand(*lrow.shape, f)
            pipe_out = state.pipe.gather(-3, lrow_f)[..., 0, :, :]  # [B, L, F]
            pause_sig = state.pause_line.gather(-2, lrow)[..., 0, :]  # [B, L]
            if soft is None:
                cap_link = torch.where(pause_sig > 0.5, 0.0, link_caps_dt)
                if has_fail:
                    cap_link = torch.where(link_down, 0.0, cap_link)
            else:
                # the delayed pause lives in [0, 1] in soft mode: re-temper
                # it about its midpoint and scale the capacity; the failure
                # mask is schedule structure and stays a 0/1 multiplier
                cap_link = ((1.0 - soft_gt(pause_sig, 0.5, soft, 0.25))
                            * link_caps * dt_s)
                if has_fail:
                    cap_link = cap_link * link_live
            cap_src = cap_link.sum(-1)
        else:
            pipe_out = state.pipe.gather(-2, row_f)[..., 0, :]
            pause_sig = state.pause_line.gather(-1, row)[..., 0]
            if soft is None:
                cap_src = torch.where(pause_sig > 0.5, 0.0, c_otn_dt)  # delayed PFC
                if has_fail:
                    cap_src = torch.where(link_down[..., 0], 0.0, cap_src)
            else:
                cap_src = ((1.0 - soft_gt(pause_sig, 0.5, soft, 0.25))
                           * c_otn * dt_s)
                if has_fail:
                    cap_src = cap_src * link_live[..., 0]

        # ------------------------------------------------ 2b. channel hook
        # what leaves the pipe is impaired before the destination OTN sees
        # it, and the source-OTN capacity may be dimmed; lost bytes ride
        # the notification ring back to the source (delay D)
        retx_arr = (state.retx_line.gather(-2, row_f)[..., 0, :] if repair
                    else zero_f)
        chan_new = None
        pipe_arrivals, lost = pipe_out, zero_f
        if impaired:
            key = None
            if keyed:
                key = step_key(chan_key0, t)                       # [B, 2]
                if multi:   # one key per link
                    key = fold_in(key[..., None, :], link_ids)     # [B, L, 2]
            eff = channel.apply_impairments(ctx, state.chan, ChannelInputs(
                t=t, key=key, pipe_out=pipe_out,
                cap_src=cap_link if multi else cap_src))
            pipe_arrivals, chan_new = eff.arrivals, eff.chan
            if multi:
                lost = eff.lost.sum(-2)
                cap_link = eff.cap_src
                cap_src = cap_link.sum(-1)
            else:
                lost, cap_src = eff.lost, eff.cap_src
        # -------------------------------------------- 2c. outage dump
        # bytes reaching the far end of a dead link are lost there and ride
        # the notification ring back, to be re-sent over the survivors
        if has_fail:
            if multi:
                pipe_arrivals, dumped = outage_dump(link_down[..., None],
                                                    pipe_arrivals)
                fail_lost = dumped.sum(-2)
            else:
                pipe_arrivals, fail_lost = outage_dump(link_down[..., :1],
                                                       pipe_arrivals)
            lost = torch.where(fail_lost > 0.0, lost + fail_lost, lost)

        # ------------------------------------------------ 3. ACK accounting
        acked = torch.where(inter, scheme.ack_view(hctx, state, ack_arr),
                            state.delivered)          # intra: ~us loop
        acked = torch.minimum(acked, state.sent)

        # ------------------------------------------------ 4. sender rates
        win_avail = clip(window - (state.sent - acked), 0.0)
        base_rate = torch.minimum(win_avail / dt_s, nic_col)
        rate = scheme.sender_rate(hctx, state, base_rate)
        # src-OTN -> sender PFC (1 step, from last-step queue)
        if soft is None:
            src_nic_pause = (state.q_src.sum(-1) > xoff_otn).to(torch.float32)
        else:
            src_nic_pause = soft_gt(state.q_src.sum(-1), xoff_otn, soft,
                                    0.05 * xoff_otn + 1.0)
        rate = rate * torch.where(inter, 1.0 - src_nic_pause[..., None], 1.0)
        # -------------------------------------------- 4b. loss repair
        # notified losses are re-sent first, at the rate the scheme grants;
        # what repair uses comes off the new-data rate (the where() keeps
        # the no-repair branch the untouched rate tensor)
        if repair:
            backlog_avail = notified_backlog(state.retx_backlog, retx_arr)
            retx_bps = clip(scheme.retx_rate(hctx, state, rate), 0.0)
            retx_send = (torch.minimum(torch.minimum(backlog_avail,
                                                     retx_bps * dt_s),
                                       nic_col * dt_s)
                         * is_inter * (1.0 - src_nic_pause[..., None]))
            rate = torch.where(retx_send > 0.0,
                               clip(rate - retx_send / dt_s, 0.0), rate)
            retx_backlog = backlog_avail - retx_send
        else:
            retx_send, retx_backlog = zero_f, zero_f
        send = rate * active * dt_s                    # bytes this step
        sent = state.sent + send

        # ------------------------------------------------ 5. source OTN
        arrivals_src = send * is_inter
        if repair:
            arrivals_src = torch.where(retx_send > 0.0,
                                       arrivals_src + retx_send, arrivals_src)
        q_src, drained_src = scheme.src_otn_release(
            hctx, state, arrivals_src, cap_src, active)
        if multi:
            # spray the release over the links: the scheme's weights masked
            # to links with capacity, rows normalised, clipped per link; what
            # a saturated link cannot take spills back into q_src
            w = clip(scheme.route_weights(hctx, state, route), 0.0)
            if soft is None:
                w = w * (cap_link > 0.0)[..., None, :]           # [B, F, L]
            else:
                # exactly 0 at cap 0: a paused or flapped link attracts
                # no spray
                w = w * soft_pos(cap_link, soft, MTU)[..., None, :]
            share = w / clip(w.sum(-1, keepdim=True), 1e-9)
            want = drained_src[..., None] * share
            link_want = want.sum(-2)                              # [B, L]
            scale = clip(cap_link / clip(link_want, 1e-9), hi=1.0)
            sent_link = (want * scale[..., None, :]).transpose(-1, -2)
            q_src = q_src + (drained_src - sent_link.sum(-2))
            pipe = _write_row(state.pipe, -3, lrow_f,
                              sent_link[..., None, :, :], inplace)
            inflight = (state.inflight + sent_link.sum(-2)
                        - pipe_out.sum(-2))
        else:
            pipe = _write_row(state.pipe, -2, row_f,
                              drained_src[..., None, :], inplace)  # at t + D
            inflight = state.inflight + drained_src - pipe_out

        # ------------------------------------------------ 6. destination OTN
        q_leaf_tot = state.q_leaf.sum(-1)
        if soft is None:
            leaf_pfc = (q_leaf_tot > xoff).to(torch.float32)
        else:
            leaf_pfc = soft_gt(q_leaf_tot, xoff, soft, 0.05 * xoff + 1.0)
        cap_dst = c_leaf_dt * (1.0 - leaf_pfc)
        if multi:
            q_dst, drained_dst = _drain_links(state.q_dst, pipe_arrivals, cap_dst)
            egress_bytes = drained_dst.flatten(-2).sum(-1)
            q_dst_tot = q_dst.flatten(-2).sum(-1)
            # per-link backlog -> per-link PFC, riding back at the link's delay
            q_dst_link = q_dst.sum(-1)                            # [B, L]
            pause_dst = pfc_hysteresis(state.pause_dst, q_dst_link, xoff_link,
                                       xon_link, soft=soft)
            pause_line = _write_row(state.pause_line, -2, lrow,
                                    pause_dst[..., None, :], inplace)
            drained_dst_f = drained_dst.sum(-2)
        else:
            q_dst, drained_dst = drain_proportional(state.q_dst, pipe_arrivals,
                                                    cap_dst)
            egress_bytes = drained_dst.sum(-1)
            q_dst_tot = q_dst.sum(-1)
            pause_dst = pfc_hysteresis(state.pause_dst, q_dst_tot, xoff_otn,
                                       xon_otn, soft=soft)
            pause_line = _write_row(state.pause_line, -1, row,
                                    pause_dst[..., None], inplace)
            drained_dst_f = drained_dst

        # ------------------------------------------------ 7. destination leaf
        arrivals_leaf = drained_dst_f + send * is_intra
        mark_p = ecn_mark_prob(q_leaf_tot, cfg, params=params, soft=soft)
        q_leaf, drained_leaf = drain_proportional(state.q_leaf, arrivals_leaf,
                                                  c_leaf_dt)
        delivered = state.delivered + drained_leaf
        marked_acc = state.marked_acc + drained_leaf * mark_p[..., None]

        # ------------------------------------------------ 8. CNP generation
        cnp_timer = state.cnp_timer + dt_us
        if soft is None:
            emit = (marked_acc >= MTU) & (cnp_timer >= cfg.cnp_interval_us)
            cnp_out = emit.to(torch.float32)
            cnp_timer = torch.where(emit, 0.0, cnp_timer)
            marked_acc = torch.where(emit, 0.0, marked_acc)
        else:
            # fractional CNPs (their consumers read them through gates at
            # the 0.5 midpoint); the timer's and accumulator's own resets
            # take the detached gate
            cnp_out = (soft_gt(marked_acc, MTU, soft, 0.1 * MTU)
                       * soft_gt(cnp_timer, cfg.cnp_interval_us, soft, dt_us))
            cnp_timer = lerp(reset_gate(cnp_out), 0.0, cnp_timer)
            marked_acc = lerp(reset_gate(cnp_out), 0.0, marked_acc)

        # ------------------------------------------------ 9. scheme feedback
        fb = scheme.feedback(hctx, state, SchemeSignals(
            t=t, active=active, sent=sent, cnp_out=cnp_out, cnp_arr=cnp_arr,
            egress_bytes=egress_bytes, q_dst_tot=q_dst_tot, q_leaf=q_leaf,
            leaf_pfc=leaf_pfc, retx_arr=retx_arr, retx_backlog=retx_backlog,
            link_sent=sent_link if multi else None,
            link_arrivals=pipe_arrivals if multi else None,
            link_want=link_want if multi else None,
            link_cap=cap_link if multi else None, host_t=host_t))

        # ------------------------------------------------ 10. return paths
        thr_inter = drained_leaf * is_inter
        ack_line = _write_row(state.ack_line, -2, row_f,
                              thr_inter[..., None, :], inplace)
        cnp_line = _write_row(state.cnp_line, -2, row_f,
                              fb.cnp_wire[..., None, :], inplace)

        # ------------------------------------------------ 11. CC update
        cc = step_dcqcn(state.cc, fb.cnp_in, send, cfg, rtt_scale=rtt_scale,
                        soft=soft)

        # ------------------------------------------------ 12. FCT
        # the completion latch stays hard in soft mode too: the INF sentinel
        # makes any blend meaningless (FCT gradients flow through the byte
        # counters)
        newly_done = (delivered >= total_bytes) & is_unfinished(state.done_at_us)
        done_at = torch.where(newly_done, t_us, state.done_at_us)

        retx_line = retx_inflight = None
        if repair:
            retx_line = _write_row(state.retx_line, -2, row_f,
                                   lost[..., None, :], inplace)
            retx_inflight = state.retx_inflight + lost - retx_arr

        new_state = SimState(
            sent=sent, acked=acked, delivered=delivered, done_at_us=done_at,
            cc=cc, cnp_timer=cnp_timer, marked_acc=marked_acc,
            proxy_timer=fb.proxy_timer, proxy_mod=fb.proxy_mod,
            q_src=q_src, q_dst=q_dst, q_leaf=q_leaf,
            pipe=pipe, inflight=inflight,
            ack_line=ack_line, cnp_line=cnp_line,
            pause_line=pause_line, pause_dst=pause_dst, extra=fb.extra,
            chan=chan_new, retx_backlog=retx_backlog if repair else None,
            retx_line=retx_line, retx_inflight=retx_inflight)
        # per-flow byte conservation residual: everything the sender emitted
        # is delivered or sits in exactly one queue, the pipe, the
        # notification ring, the retransmit backlog or a channel buffer
        q_dst_f = q_dst.sum(-2) if multi else q_dst
        residual = sent - delivered - q_src - q_dst_f - q_leaf - inflight
        if repair:
            residual = residual - retx_inflight - retx_backlog
        if impaired:
            held = channel.held_bytes(chan_new)
            if multi and torch.is_tensor(held):
                held = held.sum(-2)
            residual = residual - held
        cons_err = (magnitude(residual) / clip(sent, 1.0)).amax(-1)
        if multi:
            # capacity-weighted pause means keep the scalar keys (and the
            # Fig. 3 pause-ratio column) shape-stable across L
            pause_trace = (pause_dst * cap_w).sum(-1)
            src_paused_trace = (pause_sig * cap_w).sum(-1)
        else:
            pause_trace, src_paused_trace = pause_dst, pause_sig
        out = {
            "q_src": q_src.sum(-1),
            "q_dst": q_dst_tot,
            "q_leaf": q_leaf.sum(-1),
            "pause_dst": pause_trace,
            "src_paused": src_paused_trace,
            "thr_inter": thr_inter.sum(-1) / dt_s,
            "thr_intra": (drained_leaf * is_intra).sum(-1) / dt_s,
            "cons_err": cons_err,
        }
        if multi:
            out.update(q_dst_link=q_dst_link,        # [B, L] dst backlog
                       link_tx=sent_link.sum(-1),    # [B, L] bytes launched
                       link_pause=pause_dst)         # [B, L] PFC state
        if repair:
            # goodput = wire - lost; the repair wait is the notification
            # transit D, the virtual drain of the pending backlog at the
            # granted repair rate (floored at 1 MB/s) and the re-send
            # transit D
            backlog_tot = retx_backlog.sum(-1)
            serv_cap = clip(
                (torch.minimum(retx_bps, nic_col) * is_inter).sum(-1), 1e6)
            wait_us = torch.where(backlog_tot > 0,
                                  2.0 * d_us + backlog_tot / serv_cap * 1e6,
                                  0.0)
            out.update(chan_wire=pipe_out.flatten(-2).sum(-1) if multi
                       else pipe_out.sum(-1),
                       chan_lost=lost.sum(-1),
                       chan_retx=retx_send.sum(-1),
                       chan_backlog=backlog_tot,
                       chan_repair_wait_us=wait_us)
        if has_fail:
            # the live mask ([B, L] at L > 1, [B] on one link)
            out["fail_live"] = link_live if multi else link_live[..., 0]
        out.update(scheme.extra_traces(hctx, state))
        return new_state, out

    # shared per-run quantities for the metric machinery
    step.ctx, step.channel = ctx, channel
    step.track_chan = repair
    step.soft = soft
    return step


# ---------------------------------------------------------------------------
# Driving the step: eager on the CPU, CUDA graphs on the card
# ---------------------------------------------------------------------------


def _tree_leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tree_leaves(v)]
    return []


def _tree_clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_clone(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_tree_clone(v) for v in tree)
    return tree


class _Carry(NamedTuple):
    state: SimState
    t: torch.Tensor                  # int32 0-d: the next step's index
    acc: Optional[MetricAcc]         # metrics and window modes
    traces: Optional[torch.Tensor]   # [B, K, rows] full/decimate mode, the
                                     # [B, K, W] ring in window mode (a
                                     # per-link key takes L of the K rows)
    events: Optional[EventRing] = None   # window mode's event ring
    n: Optional[int] = None          # eager soft runs: ``t`` on the host


def _make_advance(step, scheme, mode: str, decimate: int, warm: int,
                  keys: tuple, sum_rows: Optional[torch.Tensor] = None,
                  window_steps: int = 1, events=None):
    """One step of the run with its mode's bookkeeping, ``carry -> carry``.
    Full/decimate modes write the step's trace values into row
    ``t // decimate`` of the trace buffer (the block's last step is the one
    kept, as the JAX package keeps it); under ``decimate`` the rows
    ``sum_rows`` (``DECIMATE_SUM_KEYS``) add the block's steps up instead.
    Window mode streams as metrics mode does, writes row ``t mod
    window_steps`` of its ring and, given ``events = (slots, codes)``,
    pushes the step's event candidates (read from the carry before the step
    and the state after it) into the event ring."""
    ctx, channel = step.ctx, step.channel
    k = decimate if mode == "decimate" else 1
    inplace = step.soft is None

    def advance(c: _Carry) -> _Carry:
        state, out = step(c.state, c.t, c.n)
        acc, traces, ring = c.acc, c.traces, c.events
        if mode in ("metrics", "window"):
            inc = (c.t >= warm).to(torch.float32)
            acc = _accumulate_engine(acc, out, inc, inplace)
            acc = acc._replace(scheme=scheme.accumulate_metrics(
                ctx, acc.scheme, state, out, inc))
            if step.track_chan:
                acc = acc._replace(chan=channel.accumulate_metrics(
                    ctx, acc.chan, state, out, inc))
        if mode != "metrics":
            col = (c.t % window_steps if mode == "window"
                   else c.t // k).to(torch.int64)[None]
            bs = out["q_dst"].shape
            vals = torch.cat([out[key].reshape(*bs, -1) for key in keys], -1)
            if sum_rows is not None:
                prev = traces[..., sum_rows, col]
                vals[..., sum_rows] = torch.where(
                    c.t % k == 0, vals[..., sum_rows], prev + vals[..., sum_rows])
            traces.index_copy_(-1, col, vals[..., None])
        if ring is not None:
            slots, codes = events
            cands = (list(engine_event_candidates(ctx, c.state, state, c.t))
                     + list(scheme.emit_events(ctx, c.state, state, out)))
            ring = push_events(ring, slots, c.t.to(torch.float32) * ctx.dt_us,
                               cands, codes)
        return _Carry(state, c.t + 1, acc, traces, ring,
                      None if c.n is None else c.n + 1)

    return advance


def _graph_block(steps: int, graph_block: int) -> int:
    """Steps per captured graph: ``graph_block``, or the largest divisor of
    ``steps`` above half of it, so that no second graph is captured for the
    remainder (capture time grows with the kernels captured)."""
    block = max(min(graph_block, steps), 1)
    for b in range(block, block // 2, -1):
        if steps % b == 0:
            return b
    return block


def _capture(advance, carry: _Carry, n: int, pool):
    """A CUDA graph of ``n`` advances that reads and writes ``carry``'s
    tensors in place."""
    graph = torch.cuda.CUDAGraph()
    src = _tree_leaves(carry)
    with torch.cuda.graph(graph, pool=pool):
        c = carry
        for _ in range(n):
            c = advance(c)
        for dst, new in zip(src, _tree_leaves(c)):
            if new is not dst:
                dst.copy_(new)
    return graph


def _advance_eagerly(advance, carry: _Carry, steps: int, remat: int) -> _Carry:
    """``steps`` advances, one by one; with ``remat = k > 1`` while autograd
    records, each block of k under ``torch.utils.checkpoint``: its tensors
    are dropped after the forward and made again in the backward (the steps
    are pure functions of the carry: the noise is keyed by the step
    index), so the grads are those of the plain loop, bit for bit."""
    if remat > 1 and steps > remat and torch.is_grad_enabled():
        def block(c: _Carry) -> _Carry:
            for _ in range(remat):
                c = advance(c)
            return c

        for _ in range(steps // remat):
            carry = checkpoint(block, carry, use_reentrant=False)
        steps %= remat
    for _ in range(steps):
        carry = advance(carry)
    return carry


def _drive(step, scheme, state0: SimState, steps: int, mode: str,
           decimate: int, warm: int, graph_block: int,
           profile: Optional[dict] = None):
    """Run ``steps`` steps from ``state0``; returns ``(final, aux)`` with
    ``aux`` the ``{key: [..., T']}`` trace dict, a ``MetricAcc`` or a
    ``WindowAux``. Hard steps on the card replay CUDA graphs of
    ``graph_block`` steps (0: eager); soft steps run eagerly, where autograd
    can record them (metrics mode checkpointed by ``cfg.remat_steps``).
    ``profile``, when given, receives the run's timings: ``capture_s`` (host
    seconds capturing the graphs) and ``run_ms`` (the steps' device time by
    CUDA events on the card, host time on the CPU)."""
    dev = state0.sent.device
    ctx = step.ctx
    t0 = torch.zeros((), dtype=torch.int32, device=dev)
    # one step on a copy names the trace keys (and warms the allocator)
    with torch.no_grad():
        s0 = _tree_clone(state0)
        s1, out = step(s0, t0)
    keys = tuple(out)
    bs = out["q_dst"].shape
    # each key's rows [lo, hi) of the trace buffer: one, or L for a
    # per-link key
    spans, lo = {}, 0
    for key in keys:
        hi = lo + int(np.prod(out[key].shape[len(bs):]))
        spans[key], lo = (lo, hi), hi
    acc = traces = sum_rows = ring = events = None
    window_steps = max(int(ctx.cfg.trace_window_steps), 1)
    if mode in ("metrics", "window"):
        acc = _init_metric_acc(scheme, step.channel, ctx, state0)
    if mode == "window":
        traces = torch.zeros(bs + (lo, window_steps), device=dev)
        slots = int(ctx.cfg.event_ring_slots)
        if slots > 0:
            # the candidate list is static: read it off the naming step
            cands = (list(engine_event_candidates(ctx, s0, s1, t0))
                     + list(scheme.emit_events(ctx, s0, s1, out)))
            if len(cands) > slots:
                raise ValueError(
                    f"event_ring_slots={slots} is smaller than the "
                    f"{len(cands)} per-step event candidates of this run - "
                    f"raise NetConfig.event_ring_slots so one step can "
                    f"never overflow the ring")
            events = (slots, candidate_codes(cands, dev))
            ring = init_event_ring(slots, bs, dev)
    elif mode != "metrics":
        k = decimate if mode == "decimate" else 1
        rows = steps // k
        # one spare row takes the steps past the last whole block
        traces = torch.zeros(bs + (lo, rows + 1), device=dev)
        summed = [spans[key][0] for key in DECIMATE_SUM_KEYS if key in spans]
        if k > 1 and summed:
            sum_rows = torch.tensor(summed, dtype=torch.int64, device=dev)
    del s0, s1
    carry = _Carry(state0, t0, acc, traces, ring,
                   None if step.soft is None else 0)
    advance = _make_advance(step, scheme, mode, decimate, warm, keys, sum_rows,
                            window_steps, events)
    timer = _Timer(dev)
    if dev.type == "cuda" and graph_block > 0 and step.soft is None:
        carry = _Carry(*_tree_clone(tuple(carry)))
        block = _graph_block(steps, graph_block)
        pool = torch.cuda.graph_pool_handle()
        plan = [(n, reps) for n, reps in ((block, steps // block),
                                          (steps % block, 1)) if n and reps]
        graphs = [(_capture(advance, carry, n, pool), reps) for n, reps in plan]
        timer.captured()
        for graph, reps in graphs:
            for _ in range(reps):
                graph.replay()
    else:
        timer.captured()
        remat = ctx.cfg.remat_steps if mode == "metrics" else 0
        carry = _advance_eagerly(advance, carry, steps, remat)
    if profile is not None:
        profile.update(timer.done())
    if mode == "metrics":
        return carry.state, carry.acc
    if mode == "window":
        window = {key: carry.traces[..., lo:hi, :].transpose(-1, -2).reshape(
                      bs + (window_steps,) + out[key].shape[len(bs):])
                  for key, (lo, hi) in spans.items()}
        return carry.state, WindowAux(carry.acc, window, carry.events)
    return carry.state, {
        key: (carry.traces[..., lo, :rows] if out[key].dim() == len(bs)
              else carry.traces[..., lo:hi, :rows].transpose(-1, -2))
        for key, (lo, hi) in spans.items()}


class _Timer:
    """Host time of the set-up, then the steps' time: CUDA events on the
    card (device time from the first replay to the last), host clock with
    the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.t0 = time.perf_counter()

    def captured(self):
        self.t1 = time.perf_counter()
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()

    def done(self) -> dict:
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            run_ms = self.ev[0].elapsed_time(self.ev[1])
        else:
            run_ms = (time.perf_counter() - self.t1) * 1e3
        return {"capture_s": self.t1 - self.t0, "run_ms": run_ms,
                "wall_s": time.perf_counter() - self.t0}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def simulate(cfg: NetConfig, workload, scheme, horizon_us: Optional[float] = None,
             period_slots: int = 0, delay_pad: int = 0, history_slots: int = 0,
             trace_mode: str = "full", decimate: int = 1, channel=None,
             device=None, graph_block: int = GRAPH_BLOCK):
    """Run one scenario; returns ``(final_state, traces)`` with ``[T]`` traces
    (or ``(final_state, MetricAcc)`` under ``trace_mode="metrics"``,
    ``(final_state, WindowAux)`` under ``"window"``), leaves without a batch
    axis. A batch of one through ``simulate_batch``."""
    final, aux = simulate_batch(
        [cfg], [workload] if not isinstance(workload, WorkloadParams)
        else WorkloadParams(*(np.asarray(v)[None] for v in workload)),
        scheme, horizon_us if horizon_us is not None else cfg.horizon_us,
        period_slots, trace_mode=trace_mode, decimate=decimate,
        delay_pad=delay_pad, history_slots=history_slots, channel=channel,
        device=device, graph_block=graph_block)
    return _index_tree(final, 0), _index_tree(aux, 0)


def _index_tree(tree, i):
    if torch.is_tensor(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_index_tree(v, i) for v in tree))
    return tree


def batch_padding(cfgs: Sequence[NetConfig]):
    """(delay_pad, history_slots) covering every scenario in the grid: the
    ring sizes shared by all cells of a batch (the pad absorbs any excess of
    a cell's control-processing steps over the template's)."""
    tmpl = batch_template(cfgs)
    delay_pad = (max(c.static_delay_steps for c in cfgs)
                 + max(0, max(c.control_proc_steps for c in cfgs)
                       - tmpl.control_proc_steps))
    return delay_pad, max(default_history_slots(c) for c in cfgs)


def build_batch(cfgs: Sequence[NetConfig], workload, scheme,
                period_slots: int = 0, delay_pad: int = 0,
                history_slots: int = 0, device=None, channel=None):
    """``(template, state0, step)`` of a scenario batch: the batch's static
    template, its initial state and its step function, with the rings
    padded to the batch (and at least ``delay_pad``/``history_slots``), on
    the channel model ``channel``."""
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("simulate_batch: empty config batch")
    check_main_path(channel)
    scheme = get_scheme(scheme)
    dev = resolve_device(device)
    tmpl = batch_template(cfgs)
    dp, hs = batch_padding(cfgs)
    delay_pad, history_slots = max(delay_pad, dp), max(history_slots, hs)
    params = stack_net_params(cfgs, device=dev)
    wlp = as_workload_batch(workload, len(cfgs))
    if tmpl.is_multisite:
        validate_site_endpoints(tmpl, wlp)   # host-side: stalls fail early
    state0 = init_state(tmpl, wlp.is_inter.shape[-1], params=params,
                        delay_pad=delay_pad, history_slots=history_slots,
                        scheme=scheme, channel=channel)
    step = make_step_fn(tmpl, wlp, scheme, period_slots, params=params,
                        delay_pad=delay_pad, channel=channel)
    return tmpl, state0, step


def run_traced_batch(cfg: NetConfig, params: NetParams, wlp: WorkloadParams,
                     scheme, steps: int, period_slots: int, delay_pad: int,
                     history_slots: int, mode: str = "full",
                     decimate: int = 1, warm: int = 0, channel=None):
    """Run ``steps`` steps of a batch given as stacked tensors, eagerly:
    ``cfg`` the static template (``batch_template``), ``params`` the
    ``[B]``-leading ``NetParams``, ``wlp`` the ``[B, F]`` ``WorkloadParams``
    (all on one device), ``delay_pad``/``history_slots`` the batch's ring
    sizes (``batch_padding``). Any float leaf of ``params`` or ``wlp`` may carry
    ``requires_grad``: with ``cfg.soft_step`` the streamed sums of
    ``mode="metrics"`` differentiate through ``torch.autograd`` (the
    counterpart of the JAX package's ``_run_traced_batch_impl`` under
    ``jax.grad``). Returns ``(final, aux)`` as ``simulate_batch`` does."""
    check_main_path(channel, mode, decimate)
    scheme = get_scheme(scheme)
    state0 = init_state(cfg, wlp.is_inter.shape[-1], params=params,
                        delay_pad=delay_pad, history_slots=history_slots,
                        scheme=scheme, channel=channel)
    step = make_step_fn(cfg, wlp, scheme, period_slots, params=params,
                        delay_pad=delay_pad, channel=channel)
    return _drive(step, scheme, state0, steps, mode, decimate, warm, 0)


def shard_scenario_axis(params: NetParams, wlp: WorkloadParams,
                        devices: Optional[Sequence] = None):
    """Split the stacked ``[B]``-leading scenario leaves evenly over
    ``devices``: the port of the JAX package's placement of the batch axis
    over a ``("scenario",)`` mesh. The batch is embarrassingly parallel
    along [B], so each device runs its share with no traffic between them.

    On one device (or ``devices`` None) it is a no-op and returns
    ``(params, wlp)``; with more it returns one ``(params, wlp)`` per
    device, its [B / n] rows of every leaf (tensors moved to the device,
    numpy leaves sliced). An uneven split raises."""
    devices = list(devices) if devices is not None else []
    if len(devices) <= 1:
        return params, wlp
    b = int(np.shape(params.one_way_delay_us)[0])
    if b % len(devices):
        raise ValueError(
            f"shard_scenario_axis: {len(devices)} devices do not evenly "
            f"split a batch of {b} scenarios — pad the batch to a device "
            f"multiple (runner launch plans do this automatically)")
    n = b // len(devices)

    def part(tree, i, dev):
        return type(tree)(*(x[i * n:(i + 1) * n].to(dev) if torch.is_tensor(x)
                            else x[i * n:(i + 1) * n] for x in tree))

    return [(part(params, i, torch.device(d)), part(wlp, i, torch.device(d)))
            for i, d in enumerate(devices)]


def simulate_batch(cfgs: Sequence[NetConfig], workload, scheme,
                   horizon_us: Optional[float] = None, period_slots: int = 0,
                   trace_mode: str = "full", decimate: int = 1,
                   delay_pad: int = 0, history_slots: int = 0,
                   warm_steps: Optional[int] = None, channel=None,
                   device=None, graph_block: int = GRAPH_BLOCK,
                   profile: Optional[dict] = None):
    """Run a whole scenario grid as one ``[B]`` batch.

    ``cfgs``: the per-scenario configs; every static field must match (the
    per-scenario scalars go into a stacked ``NetParams``). ``workload``: one
    shared ``Workload``, one per scenario, or stacked ``[B, F]``
    ``WorkloadParams``. Returns ``(final_states, traces)`` with a leading
    ``[B]`` axis on every leaf, ``(final_states, MetricAcc)`` under
    ``trace_mode="metrics"`` or ``(final_states, WindowAux)`` under
    ``"window"``. ``delay_pad``/``history_slots`` set MINIMUM
    ring sizes; ``warm_steps`` overrides the warm-up cutoff of the streamed
    reductions. ``channel``: a registered channel-model name or model (None
    = ideal); its knobs are per-scenario ``NetParams`` leaves, so an
    impairment grid is one batch. ``device``: where the batch runs, ``cuda``
    unless the caller says (raises without a GPU). ``graph_block``: steps per captured CUDA
    graph on the card; 0 runs the steps eagerly there (the reference the
    graphs are held to). ``profile``: a dict that receives ``steps``,
    ``cells`` and the run's timings (see ``_drive``)."""
    cfgs = list(cfgs)
    check_main_path(channel, trace_mode, decimate)
    tmpl, state0, step = build_batch(cfgs, workload, scheme, period_slots,
                                     delay_pad, history_slots, device, channel)
    steps = tmpl.horizon_steps(
        horizon_us if horizon_us is not None
        else max(c.horizon_us for c in cfgs))
    warm = int(steps * WARMUP_FRAC) if warm_steps is None else int(warm_steps)
    if profile is not None:
        profile.update(steps=steps, cells=len(cfgs))
    return _drive(step, get_scheme(scheme), state0, steps, trace_mode,
                  decimate, warm, graph_block, profile)
