"""Network configuration for the port's netsim: ``NetConfig`` and ``NetParams``.

A copy of the JAX package's ``NetConfig`` (every field and default, which
``tests/test_torch_netsim_core.py`` holds equal) with its host helpers, and
the torch twin of ``NetParams``: the traced per-scenario scalars as f32
tensors on the run's device, stacked to a leading ``[B]`` axis for a batch.
``NetConfig`` stays the static side: it fixes ``dt_us``, the slot layout, the
DCQCN constants and every ring size.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch


class NetParams(NamedTuple):
    """Per-scenario network parameters, one f32 tensor each.

    ``NetParams.of(cfg)`` gives 0-d leaves (the link leaves ``[L]``, the
    schedule tables ``[L, K, 3]`` and ``[L, W, 2]``); ``stack_net_params``
    gives each leaf a leading ``[B]`` axis. The step reads every scalar a
    sweep varies from here, so one step function serves a whole batch.
    """

    one_way_delay_us: Any        # f32 - long-haul one-way propagation delay
    otn_capacity_gbps: Any       # f32 - aggregate OTN line capacity
    dst_dc_gbps: Any             # f32 - destination leaf capacity
    nic_gbps: Any                # f32 - sender NIC line rate
    pfc_xoff_kb: Any             # f32 - DC-leaf PFC pause threshold
    pfc_xon_kb: Any              # f32 - DC-leaf PFC resume threshold
    otn_buffer_bdp_frac: Any     # f32 - OTN PFC headroom as a BDP fraction
    ecn_kmin_kb: Any             # f32 - ECN marking lower threshold
    ecn_kmax_kb: Any             # f32 - ECN marking upper threshold
    queue_thresh_kb: Any         # f32 - dst-OTN backlog threshold (slots)
    budget_floor_mbps: Any       # f32 - budget floor
    budget_headroom: Any         # f32 - inject <= headroom * estimated r_out
    geopipe_credit_bdp_frac: Any  # f32 - related-work scheme knobs
    sdr_window_bdp_frac: Any
    sdr_ack_coalesce_us: Any
    sdr_retx_budget_frac: Any
    loss_rate: Any               # f32 - channel-impairment knobs
    loss_burst_len: Any
    jitter_us: Any
    flap_period_us: Any
    flap_depth: Any
    rdmacell_token_bucket_us: Any  # f32 - rdmacell knobs
    rdmacell_rob_limit_mb: Any
    slot_us: Any                 # f32 - MatchRDMA slot duration (us)
    soft_temp: Any               # f32 - soft-step temperature
    link_delay_us: Any           # f32[L] - per-link one-way delay
    link_cap_gbps: Any           # f32[L] - per-link line capacity
    link_thresh_kb: Any          # f32[L] - per-link dst-OTN PFC threshold
    chan_schedule: Any           # f32[L, K, 3] - trace-replay schedule
    chan_sched_dt_us: Any        # f32 - schedule entry duration
    fail_windows: Any            # f32[L, W, 2] - (down_at_us, up_at_us)

    @classmethod
    def of(cls, cfg: "NetConfig", device=None) -> "NetParams":
        return cls(*(torch.as_tensor(v, device=device) for v in _host_leaves(cfg)))

    def delay_steps(self, dt_us: float) -> torch.Tensor:
        """Step count of the long-haul delay (>= 1), int32, in f32 arithmetic."""
        return torch.clamp(
            torch.round(self.one_way_delay_us / dt_us).to(torch.int32), min=1)


def _host_leaves(cfg: "NetConfig") -> tuple:
    """Each ``NetParams`` leaf of ``cfg`` as an f32 numpy array."""
    scalars = tuple(np.float32(v) for v in (
        cfg.one_way_delay_us, cfg.otn_capacity_gbps, cfg.dst_dc_gbps,
        cfg.nic_gbps, cfg.pfc_xoff_kb, cfg.pfc_xon_kb,
        cfg.otn_buffer_bdp_frac, cfg.ecn_kmin_kb, cfg.ecn_kmax_kb,
        cfg.queue_thresh_kb, cfg.budget_floor_mbps,
        cfg.budget_headroom, cfg.geopipe_credit_bdp_frac,
        cfg.sdr_window_bdp_frac, cfg.sdr_ack_coalesce_us,
        cfg.sdr_retx_budget_frac, cfg.loss_rate, cfg.loss_burst_len,
        cfg.jitter_us, cfg.flap_period_us, cfg.flap_depth,
        cfg.rdmacell_token_bucket_us, cfg.rdmacell_rob_limit_mb,
        cfg.slot_us, cfg.soft_temp))
    return scalars + (
        np.asarray(cfg.path_delays_us(), np.float32),
        np.asarray(cfg.path_caps_gbps(), np.float32),
        np.asarray(cfg.path_pfc_kb(), np.float32),
        cfg.schedule_array(),
        np.float32(cfg.channel_schedule_dt_us),
        cfg.failure_array())


def stack_net_params(cfgs: Sequence["NetConfig"], device=None) -> NetParams:
    """Stack per-scenario params into one ``[B]``-leading ``NetParams``."""
    lens = {c.schedule_len for c in cfgs}
    if len(lens) > 1:
        raise ValueError(
            f"stack_net_params: channel_schedule lengths differ across the "
            f"batch ({sorted(lens)}) - every scenario must carry the same "
            f"number of entries (pad shorter schedules)")
    wlens = {c.failure_len for c in cfgs}
    if len(wlens) > 1:
        raise ValueError(
            f"stack_net_params: failure_schedule window counts differ "
            f"across the batch ({sorted(wlens)}) - pad with no-op (0, 0) "
            f"windows to a common count")
    cols = zip(*(_host_leaves(c) for c in cfgs))
    return NetParams(*(torch.as_tensor(np.stack(col), device=device)
                       for col in cols))


# NetConfig fields whose values reach the batched step ONLY through the
# NetParams leaves - free to vary per scenario. Every OTHER field is static
# structure and must be identical across a batch; ``batch_template`` resets
# these to the class defaults.
NET_TRACED_FIELDS = ("distance_km", "num_otn_links", "link_gbps",
                     "dst_dc_gbps", "nic_gbps", "pfc_xoff_kb", "pfc_xon_kb",
                     "otn_buffer_bdp_frac", "ecn_kmin_kb", "ecn_kmax_kb",
                     "queue_thresh_kb", "budget_floor_mbps",
                     "budget_headroom", "geopipe_credit_bdp_frac",
                     "sdr_window_bdp_frac", "sdr_ack_coalesce_us",
                     "sdr_retx_budget_frac", "loss_rate", "loss_burst_len",
                     "jitter_us", "flap_period_us", "flap_depth",
                     "rdmacell_token_bucket_us", "rdmacell_rob_limit_mb",
                     "slot_us", "soft_temp",
                     "path_delay_scale", "path_cap_frac", "path_thresh_kb",
                     "channel_schedule", "channel_schedule_dt_us",
                     "failure_schedule")


def batch_template(cfgs: Sequence["NetConfig"]) -> "NetConfig":
    """The static template of a batch: the shared non-traced fields, with
    every ``NetParams``-covered field reset to its class default. A
    non-traced field that varies across the batch is an error."""
    for fld in dataclasses.fields(NetConfig):
        if fld.name in NET_TRACED_FIELDS:
            continue
        vals = {getattr(c, fld.name) for c in cfgs}
        if len(vals) > 1:
            raise ValueError(
                f"simulate_batch: NetConfig.{fld.name} must be identical "
                f"across the batch (got {sorted(vals)}) - it is static "
                f"structure, not a NetParams leaf")
    defaults = {f.name: f.default for f in dataclasses.fields(NetConfig)}
    return dataclasses.replace(
        cfgs[0], **{f: defaults[f] for f in NET_TRACED_FIELDS})


@dataclass(frozen=True)
class NetConfig:
    """MatchRDMA / netsim parameters. Defaults follow the paper's Fig. 3 setup."""

    # topology
    num_otn_links: int = 16
    link_gbps: float = 100.0              # per OTN link
    intra_dc_delay_us: float = 1.0        # one-way
    distance_km: float = 100.0            # inter-DC distance
    dst_dc_gbps: float = 400.0            # destination leaf capacity (shared w/ intra traffic)
    nic_gbps: float = 400.0               # server NIC line rate
    # multi-path long haul (docs/topology.md). ``num_paths`` is STATIC —
    # it fixes the [L] link-axis shape and keys the compile; at the default
    # 1 the engine takes the single-pipe path the goldens pin bit-for-bit.
    # The per-path tuples are traced values (length 0 or num_paths; () =
    # the symmetric default): delay multipliers on one_way_delay_us,
    # capacity fractions of otn_capacity_gbps (default: equal split), and
    # per-path dst-OTN PFC thresholds (default: pfc_xoff_kb).
    num_paths: int = 1
    path_delay_scale: tuple = ()
    path_cap_frac: tuple = ()
    path_thresh_kb: tuple = ()
    # multi-SITE graph (docs/sites.md). ``num_sites`` is STATIC; each of
    # the ``num_paths`` links is a directed site-pair EDGE: ``site_edges``
    # is () (= every link connects site 0 -> 1, the legacy single pair) or
    # a length-num_paths tuple of (src_site, dst_site) pairs. A flow only
    # sprays onto edges matching its (src_site, dst_site) endpoints
    # (``FlowSpec``); at the defaults the engine emits the identical
    # program it emitted before sites existed (goldens pin this).
    num_sites: int = 2
    site_edges: tuple = ()
    # trace-replay channel schedule (docs/channel-models.md): a recorded
    # per-edge impairment timeline for the ``trace_replay`` channel model.
    # () = no schedule, or a length-num_paths tuple of per-edge entry
    # tuples, each entry a (loss_frac, defer_frac, cap_frac) triple
    # covering ``channel_schedule_dt_us`` of simulated time (<= 0 = one
    # entry per dt_us step; the schedule loops past its end). The VALUES
    # are traced NetParams leaves; the entry count K is static shape.
    channel_schedule: tuple = ()
    channel_schedule_dt_us: float = 0.0
    # hard-failure schedule (docs/failures.md): link/site outage timelines
    # for the ``repro.netsim.failures`` subsystem. () = no failures, or a
    # length-num_paths tuple of per-edge window tuples, each window a
    # (down_at_us, up_at_us) pair during which that link is DEAD (zero
    # capacity, in-flight bytes dumped into the retransmit path). All
    # edges carry the same window count W (pad with no-op (0, 0) windows —
    # ``FailureSchedule`` builds/pads these). The window TIMES are traced
    # NetParams leaves; W is static shape keying the compile.
    failure_schedule: tuple = ()

    # simulation
    dt_us: float = 5.0                    # fluid integration step
    horizon_us: float = 100_000.0         # simulated time

    # DCQCN (values follow Zhu et al. SIGCOMM'15 conventions)
    ecn_kmin_kb: float = 200.0
    ecn_kmax_kb: float = 1600.0
    ecn_pmax: float = 0.2
    dcqcn_g: float = 1.0 / 256.0
    dcqcn_rai_mbps: float = 300.0         # additive increase
    dcqcn_hai_mbps: float = 1500.0        # hyper increase
    dcqcn_alpha_timer_us: float = 55.0
    dcqcn_rate_timer_us: float = 300.0    # rate-increase timer
    dcqcn_bytes_counter_mb: float = 10.0
    cnp_interval_us: float = 50.0         # min CNP spacing per flow
    min_rate_mbps: float = 100.0

    # PFC
    pfc_xoff_kb: float = 2048.0           # pause threshold (DC leaf switches)
    pfc_xon_kb: float = 1024.0
    # OTN nodes carry long-haul BDP: their PFC headroom scales with 2D
    otn_buffer_bdp_frac: float = 0.10     # xoff_otn = max(xoff, frac*C_otn*2D)

    # MatchRDMA controller
    slot_us: float = 100.0                # slot duration (Fig. 2e)
    slots_per_window: int = 8             # consecutive slots aggregated
    ack_delay_thresh_us: float = 20.0     # slot congestion classification
    cnp_freq_thresh: float = 0.5          # CNPs/slot threshold
    queue_thresh_kb: float = 256.0        # local dst-OTN backlog threshold
    stable_cv_thresh: float = 0.15        # coefficient-of-variation gate
    stable_weight: float = 4.0            # weight of stable recurrent windows
    jitter_weight: float = 1.0            # conservative weight of jittery slots
    budget_headroom: float = 0.98         # inject at <= headroom * estimated r_out
    budget_probe: float = 1.10            # clear-regime probe factor per ctrl window
    budget_floor_mbps: float = 500.0
    control_proc_slots: int = 1           # OTN processing delay (slots)

    # Related-work scheme knobs (traced NetParams leaves — sweep batch-wide).
    # GeoPipe-style lossless pipeline shaping: the source OTN may hold at
    # most frac x (2D x C_otn) bytes outstanding toward the destination
    # segment (credits return with one-way delay D; 1.0 is exactly
    # rate-sustaining at line rate). The default provisions the window
    # WITHIN the segment buffer (< otn_buffer_bdp_frac), so pacing stays
    # PFC-free: the credit gate, not a pause frame, is the backpressure.
    geopipe_credit_bdp_frac: float = 0.08
    # SDR-RDMA-style software-defined reliability: per-flow selective-repeat
    # receive window as a BDP fraction, receiver ACK-coalescing interval,
    # and the sender rate share reserved for repair traffic under loss
    # (scaled by the observed congestion level).
    sdr_window_bdp_frac: float = 1.0
    sdr_ack_coalesce_us: float = 50.0
    sdr_retx_budget_frac: float = 0.05
    # RDMACell-style flowcell spraying (traced NetParams leaves, consumed
    # only by the `rdmacell` scheme): per-link token-bucket depth in µs of
    # that link's line rate, and the destination reorder-buffer budget the
    # sender gate keeps occupancy under (docs/topology.md).
    rdmacell_token_bucket_us: float = 50.0
    rdmacell_rob_limit_mb: float = 64.0

    # Channel-impairment knobs (traced NetParams leaves — an impairment
    # grid sweeps batch-wide in one compiled program per scheme). Only
    # non-ideal channel models (repro.netsim.channel) consume them; the
    # defaults describe a perfect pipe, so the `ideal` channel and a zeroed
    # lossy channel are bit-identical.
    loss_rate: float = 0.0        # stationary fraction of long-haul bytes lost
    loss_burst_len: float = 1.0   # mean Gilbert–Elliott Bad dwell (steps);
                                  # 1.0 degenerates to i.i.d. Bernoulli
    jitter_us: float = 0.0        # mean stochastic extra one-way delay
    flap_period_us: float = 0.0   # OTN protection-switch period (0 = off)
    flap_depth: float = 0.0       # long-haul capacity cut inside a dip [0,1]
    channel_seed: int = 0         # static PRNG seed of the impairment draws
                                  # (counter-based: folded with the scan step)

    # Differentiable engine (docs/differentiable.md). ``soft_step`` is
    # STATIC structure: True swaps every knob-dependent hard select in the
    # step function for a sigmoid-tempered blend so gradients flow through
    # the scan (the port has only the hard step and raises on True).
    # ``soft_temp`` is the temperature leaf (→ 0 recovers the hard gates);
    # ``remat_steps`` > 0 checkpoints the scan for reverse-mode AD and
    # leaves forward values unchanged, so the port's forward ignores it.
    soft_step: bool = False
    soft_temp: float = 1.0
    remat_steps: int = 0

    # Observability (docs/observability.md). Both STATIC — they size scan
    # carries, so they key the compile and must match across a batch.
    # ``event_ring_slots`` > 0 carries a bounded per-scenario event ring
    # through the scan (``trace_mode="window"`` only): discrete events
    # (PFC edges, threshold crossings, retx onset, failure entry/exit,
    # ``Scheme.emit_events``) are timestamped in O(E) device memory; 0 (the
    # default) carries none. ``trace_window_steps`` is the
    # ring length W of the windowed trace carry — ``trace_mode="window"``
    # keeps the LAST W steps of every trace key in O(W) memory.
    event_ring_slots: int = 0
    trace_window_steps: int = 256

    @property
    def one_way_delay_us(self) -> float:
        # 5 µs per km (paper: 1 km -> 5 µs ... 1000 km -> 5 ms)
        return 5.0 * self.distance_km

    @property
    def otn_capacity_gbps(self) -> float:
        return self.num_otn_links * self.link_gbps

    # -- per-path topology (the [L] link axis; L = num_paths, static) ------
    def _path_tuple(self, vals: tuple, default: float, what: str) -> tuple:
        if len(vals) not in (0, self.num_paths):
            raise ValueError(
                f"NetConfig.{what}: expected {self.num_paths} entries "
                f"(num_paths) or an empty tuple, got {len(vals)}")
        return tuple(float(v) for v in vals) if vals \
            else (default,) * self.num_paths

    def path_delays_us(self) -> tuple:
        """Per-path one-way delays (µs), length ``num_paths``."""
        scales = self._path_tuple(self.path_delay_scale, 1.0,
                                  "path_delay_scale")
        return tuple(self.one_way_delay_us * s for s in scales)

    def path_caps_gbps(self) -> tuple:
        """Per-path line capacities (Gbps); the default splits the
        aggregate OTN capacity equally, so L equal paths carry exactly the
        single pipe's total."""
        fracs = self._path_tuple(self.path_cap_frac, 1.0 / self.num_paths,
                                 "path_cap_frac")
        return tuple(self.otn_capacity_gbps * f for f in fracs)

    def path_pfc_kb(self) -> tuple:
        """Per-path dst-OTN PFC thresholds (KB; default pfc_xoff_kb)."""
        return self._path_tuple(self.path_thresh_kb, self.pfc_xoff_kb,
                                "path_thresh_kb")

    # -- multi-site graph (edges over the link axis; docs/sites.md) --------
    def edge_pairs(self) -> tuple:
        """Resolved per-link (src_site, dst_site) pairs, length
        ``num_paths``. The default () wires every link as the legacy
        0 -> 1 site pair. Validates the graph: site indices in range,
        no self-edges."""
        if self.num_sites < 2:
            raise ValueError(
                f"NetConfig.num_sites must be >= 2, got {self.num_sites}")
        if not self.site_edges:
            return ((0, 1),) * self.num_paths
        if len(self.site_edges) != self.num_paths:
            raise ValueError(
                f"NetConfig.site_edges: expected {self.num_paths} "
                f"(num_paths) directed (src, dst) pairs or an empty tuple, "
                f"got {len(self.site_edges)}")
        pairs = []
        for e in self.site_edges:
            if len(e) != 2:
                raise ValueError(
                    f"NetConfig.site_edges: each edge is a (src_site, "
                    f"dst_site) pair, got {e!r}")
            s, d = int(e[0]), int(e[1])
            if not (0 <= s < self.num_sites and 0 <= d < self.num_sites):
                raise ValueError(
                    f"NetConfig.site_edges: edge ({s}, {d}) references a "
                    f"site outside [0, {self.num_sites})")
            if s == d:
                raise ValueError(
                    f"NetConfig.site_edges: self-edge ({s}, {d}) — a link "
                    f"must connect two distinct sites")
            pairs.append((s, d))
        return tuple(pairs)

    @property
    def is_multisite(self) -> bool:
        """True when the config declares a genuine site graph (more than
        two sites, or explicit edge wiring). At False the engine takes the
        legacy single-pair path — bit-identical to the pre-sites
        programs the goldens pin."""
        return self.num_sites > 2 or bool(self.site_edges)

    # -- trace-replay schedule (docs/channel-models.md) --------------------
    @property
    def schedule_len(self) -> int:
        """Static entry count K of the channel schedule (0 = none).
        Validates the nested tuple: one per-edge timeline per link, all of
        equal length, each entry a (loss_frac, defer_frac, cap_frac)
        triple."""
        if not self.channel_schedule:
            return 0
        if len(self.channel_schedule) != self.num_paths:
            raise ValueError(
                f"NetConfig.channel_schedule: expected {self.num_paths} "
                f"(num_paths) per-edge timelines or an empty tuple, got "
                f"{len(self.channel_schedule)}")
        lens = {len(edge) for edge in self.channel_schedule}
        if len(lens) > 1:
            raise ValueError(
                f"NetConfig.channel_schedule: per-edge timelines differ in "
                f"length ({sorted(lens)}) — pad them to a common K")
        for edge in self.channel_schedule:
            for entry in edge:
                if len(entry) != 3:
                    raise ValueError(
                        f"NetConfig.channel_schedule: each entry is a "
                        f"(loss_frac, defer_frac, cap_frac) triple, got "
                        f"{entry!r}")
        return lens.pop() if lens else 0

    def schedule_array(self):
        """The schedule as an f32 [L, K, 3] numpy table (the traced
        ``NetParams.chan_schedule`` leaf; [L, 0, 3] when unset)."""
        k = self.schedule_len
        if k == 0:
            return np.zeros((self.num_paths, 0, 3), np.float32)
        return np.asarray(self.channel_schedule, np.float32)

    # -- failure schedule (docs/failures.md) -------------------------------
    @property
    def failure_len(self) -> int:
        """Static window count W of the failure schedule (0 = none).
        Validates the nested tuple: one per-edge window list per link, all
        of equal length, each window a (down_at_us, up_at_us) pair. A
        window with up <= down is a no-op (the padding convention)."""
        if not self.failure_schedule:
            return 0
        if len(self.failure_schedule) != self.num_paths:
            raise ValueError(
                f"NetConfig.failure_schedule: expected {self.num_paths} "
                f"(num_paths) per-edge window lists or an empty tuple, got "
                f"{len(self.failure_schedule)}")
        lens = {len(edge) for edge in self.failure_schedule}
        if len(lens) > 1:
            raise ValueError(
                f"NetConfig.failure_schedule: per-edge window lists differ "
                f"in length ({sorted(lens)}) — pad with no-op (0, 0) "
                f"windows to a common W (FailureSchedule does this)")
        for li, edge in enumerate(self.failure_schedule):
            for win in edge:
                if len(win) != 2:
                    raise ValueError(
                        f"NetConfig.failure_schedule: edge {li}: each "
                        f"window is a (down_at_us, up_at_us) pair, got "
                        f"{win!r}")
                d, u = float(win[0]), float(win[1])
                if d < 0.0 or u < 0.0:
                    raise ValueError(
                        f"NetConfig.failure_schedule: edge {li}: window "
                        f"times must be >= 0, got ({d}, {u})")
        return lens.pop() if lens else 0

    def failure_array(self):
        """The outage windows as an f32 [L, W, 2] numpy table (the traced
        ``NetParams.fail_windows`` leaf; [L, 0, 2] when unset)."""
        w = self.failure_len
        if w == 0:
            return np.zeros((self.num_paths, 0, 2), np.float32)
        return np.asarray(self.failure_schedule, np.float32)

    @property
    def control_proc_steps(self) -> int:
        """Control-subchannel OTN processing delay in fluid steps — the one
        definition every control channel (budget, credit grants) sizes its
        delay line with."""
        return int(self.control_proc_slots * self.slot_us / self.dt_us)

    @property
    def static_delay_steps(self) -> int:
        """STATIC one-way-delay step count — the one definition every
        delay-ring allocation shares. Uses the same f32 arithmetic as the
        traced ``NetParams.delay_steps`` so a static ring size can never
        undercut the traced wrap index (f64 here could round 3.4999...
        down where the f32 leaf rounds up — the ring would then be written
        through a clamped out-of-range index). With ``num_paths > 1`` this
        is the MAX over the per-path delays, so one ring allocation covers
        every link's wrap index."""
        return max(max(int(np.round(np.float32(d) / np.float32(self.dt_us)))
                       for d in self.path_delays_us()), 1)

    def horizon_steps(self, horizon_us: float = None) -> int:
        """Scan length for a horizon (default: this config's) — the single
        definition both ``simulate`` and ``simulate_batch`` size their scans
        (and warm-up cutoffs) with."""
        h = self.horizon_us if horizon_us is None else horizon_us
        return int(round(h / self.dt_us))

    def params(self, device=None) -> NetParams:
        """The per-scenario side of the static/per-scenario split."""
        return NetParams.of(self, device=device)
