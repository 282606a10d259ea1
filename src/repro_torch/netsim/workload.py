"""Flow/workload specification for the port's netsim fluid simulator.

A copy of the JAX package's ``netsim/workload.py`` (numpy only), kept here so
that the port imports nothing of that package; the host arrays it builds are
equal to the JAX package's.

A workload is a set of flows with AICB-like on/off structure (LLM training
alternates compute and communication phases). Inter-DC flows traverse
sender NIC -> source OTN -> long-haul pipe -> destination OTN -> destination
leaf; intra-DC flows contend only at the destination leaf.

``WorkloadParams`` is the per-scenario side of the workload axis — the twin of
``NetParams`` on the config axis. Its leaves are the stacked per-flow
arrays the step function reads, padded to a common flow count with an
``active_mask`` (padded flows never send, never complete, never count), so
``simulate_batch`` can run heterogeneous (config × workload) scenario grids
as one ``[B]`` batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Union

import numpy as np

BIG = 1e18  # "unbounded" total bytes (throughput experiments)


def is_unbounded(total_bytes):
    """True where ``total_bytes`` carries the BIG 'unbounded' sentinel.

    The one definition both metric paths compare against (works on numpy
    and torch arrays). f32-safe: a sentinel that round-tripped through f32
    still clears the BIG/2 threshold.
    """
    return total_bytes >= BIG / 2


@dataclass(frozen=True)
class FlowSpec:
    is_inter: bool
    msg_size: float            # bytes per message
    concurrency: int           # parallel in-flight messages
    total_bytes: float = BIG   # flow size (finite => FCT experiment)
    start_us: float = 0.0
    period_us: float = 0.0     # 0 => always-on; else AICB on/off period
    duty: float = 1.0          # fraction of the period spent communicating
    # per-link routing weights over the cfg.num_paths parallel long-haul
    # links (docs/topology.md). () = symmetric default (equal weight on
    # every link); a length-L tuple steers this flow's spray proportions.
    # Intra-DC flows never reach the long haul, so their row is unused.
    route: tuple = ()
    # endpoint sites on the cfg site graph (docs/sites.md). An inter-DC
    # flow only sprays onto links whose (src_site, dst_site) edge matches
    # its endpoints; the defaults name the legacy 0 -> 1 pair, so
    # single-pair workloads need not mention sites at all. Intra-DC flows
    # contend at dst_site's leaf; their src_site is unused.
    src_site: int = 0
    dst_site: int = 1

    @property
    def window(self) -> float:
        return self.msg_size * self.concurrency


class WorkloadParams(NamedTuple):
    """Per-scenario workload leaves (numpy; the engine moves them to its device).

    Per-flow [F] arrays (or [B, F] once stacked for a batch). Padded flows
    carry ``active_mask == 0`` and zeroed fields: they never become active,
    contribute zero bytes to every queue/sum, and are excluded from the
    metric extractors (``is_inter == 0`` and ``total_bytes == 0``).
    """

    is_inter: np.ndarray         # f32 — 1.0 for inter-DC flows
    window: np.ndarray           # f32 — msg_size * concurrency (bytes)
    total_bytes: np.ndarray      # f32 — flow size (BIG = unbounded)
    start_us: np.ndarray         # f32
    period_us: np.ndarray        # f32 — 0 = always-on
    duty: np.ndarray             # f32
    active_mask: np.ndarray      # f32 — 0.0 marks batch-padding flows
    route: np.ndarray            # f32[..., F, L] — per-flow x per-link spray
                                 # weights (width 1 = the symmetric default,
                                 # broadcast to cfg.num_paths by the engine)
    src_site: np.ndarray         # f32 — source site index (docs/sites.md)
    dst_site: np.ndarray         # f32 — destination site index

    @classmethod
    def of(cls, workload: "Workload", pad_to: int = 0,
           link_pad: int = 0) -> "WorkloadParams":
        """Per-flow arrays for one workload, zero-padded to ``pad_to``
        flows (and the route leaf to ``link_pad`` links)."""
        a = workload.arrays()
        f = workload.num_flows
        pad = max(pad_to, f) - f

        def _p(x, fill=0.0):
            x = np.asarray(x, np.float32)
            return np.pad(x, (0, pad), constant_values=fill) if pad else x

        routes = [x.route for x in workload.flows]
        width = max(max((len(r) for r in routes), default=1),
                    link_pad, 1)
        # default row: equal weight everywhere. An explicit route shorter
        # than the widest pads with zero weight — the flow never sprays
        # onto links it did not name.
        route = np.ones((f, width), np.float32)
        for i, r in enumerate(routes):
            if r:
                row = np.zeros((width,), np.float32)
                row[:len(r)] = np.asarray(r, np.float32)
                route[i] = row
        if pad:
            route = np.pad(route, ((0, pad), (0, 0)))

        return cls(
            is_inter=_p(a["is_inter"]),
            window=_p(a["window"]),
            total_bytes=_p(a["total_bytes"]),
            start_us=_p(a["start_us"]),
            period_us=_p(a["period_us"]),
            duty=_p(a["duty"]),
            active_mask=_p(np.ones((f,), np.float32)),
            route=route,
            src_site=_p(a["src_site"]),
            dst_site=_p(a["dst_site"]),
        )

    @property
    def num_flows(self) -> int:
        return int(self.active_mask.shape[-1])

    @property
    def route_width(self) -> int:
        return int(self.route.shape[-1])


WorkloadLike = Union["Workload", WorkloadParams]


def stack_workload_params(workloads: Sequence["Workload"],
                          pad_to: int = 0) -> WorkloadParams:
    """Pad a workload grid to its max flow count and stack to [B, F] leaves
    — the workload-axis twin of ``config.base.stack_net_params``."""
    workloads = list(workloads)
    if not workloads:
        raise ValueError("stack_workload_params: empty workload batch")
    pad = max(pad_to, max(w.num_flows for w in workloads))
    link_pad = max(max((len(f.route) for f in w.flows), default=1)
                   for w in workloads)
    cells = [WorkloadParams.of(w, pad_to=pad, link_pad=link_pad)
             for w in workloads]
    return WorkloadParams(*(np.stack(leaves)
                            for leaves in zip(*cells)))


def as_workload_batch(workload, batch_size: int) -> WorkloadParams:
    """Normalize the workload argument of a batched run to [B, F] leaves.

    Accepts one shared ``Workload`` (replicated across the batch), a
    per-scenario sequence of ``Workload``s (padded + stacked), or an
    already-stacked ``WorkloadParams``.
    """
    if isinstance(workload, WorkloadParams):
        if workload.is_inter.ndim != 2 or \
                workload.is_inter.shape[0] != batch_size:
            raise ValueError(
                f"as_workload_batch: expected [B={batch_size}, F] stacked "
                f"WorkloadParams, got shape {workload.is_inter.shape}")
        return workload
    if isinstance(workload, Workload):
        workloads = [workload] * batch_size
    else:
        workloads = list(workload)
        if len(workloads) != batch_size:
            raise ValueError(
                f"as_workload_batch: {len(workloads)} workloads for "
                f"{batch_size} scenarios — pass one per scenario (or one "
                f"shared Workload)")
    return stack_workload_params(workloads)


@dataclass(frozen=True)
class Workload:
    flows: tuple

    @property
    def num_flows(self) -> int:
        return len(self.flows)

    def arrays(self) -> dict:
        """Stack flow fields into numpy arrays for the simulator."""
        f = self.flows
        return {
            "is_inter": np.array([x.is_inter for x in f], np.float32),
            "msg_size": np.array([x.msg_size for x in f], np.float32),
            "window": np.array([x.window for x in f], np.float32),
            "total_bytes": np.array([x.total_bytes for x in f], np.float32),
            "start_us": np.array([x.start_us for x in f], np.float32),
            "period_us": np.array([x.period_us for x in f], np.float32),
            "duty": np.array([x.duty for x in f], np.float32),
            "src_site": np.array([x.src_site for x in f], np.float32),
            "dst_site": np.array([x.dst_site for x in f], np.float32),
        }

    def params(self, pad_to: int = 0) -> WorkloadParams:
        """The per-scenario side of the workload axis."""
        return WorkloadParams.of(self, pad_to=pad_to)


def throughput_workload(msg_size: float, concurrency: int,
                        num_flows: int = 4) -> Workload:
    """Fig. 3(b): inter-DC flows only, unbounded bytes, always-on."""
    return Workload(tuple(
        FlowSpec(True, msg_size, concurrency) for _ in range(num_flows)))


def congestion_workload(msg_size: float = 1 << 20, concurrency: int = 16,
                        num_inter: int = 8, num_intra: int = 8,
                        burst_start_us: float = 20_000.0,
                        burst_len_us: float = 40_000.0,
                        horizon_us: float = 100_000.0) -> Workload:
    """Fig. 3(c,d): inter-DC load + an intra-DC burst that congests the
    destination leaf mid-run (the 'downstream forwarding temporarily slowed'
    scenario of Fig. 1)."""
    inter = [FlowSpec(True, msg_size, concurrency) for _ in range(num_inter)]
    intra = [FlowSpec(False, 256 << 10, 8,
                      start_us=burst_start_us,
                      period_us=horizon_us,
                      duty=burst_len_us / horizon_us)
             for _ in range(num_intra)]
    return Workload(tuple(inter + intra))


def mixed_fct_workload(msg_size: float, num_inter: int = 8,
                       num_intra: int = 8, messages_per_flow: int = 4,
                       concurrency: int = 4, num_background: int = 4,
                       request_start_us: float = 30_000.0) -> Workload:
    """Fig. 3(e): mixed-traffic scenario. Continuous inter-DC LLM training
    traffic (background) + finite inter-DC transfers (the measured
    'communication requests') + steady intra-DC traffic sharing the
    destination leaf. Metric = average completion time of the finite
    inter-DC flows."""
    background = [FlowSpec(True, 1 << 20, 16) for _ in range(num_background)]
    inter = [FlowSpec(True, msg_size, concurrency,
                      total_bytes=msg_size * messages_per_flow * concurrency,
                      start_us=request_start_us + 100.0 * i)
             for i in range(num_inter)]
    intra = [FlowSpec(False, 64 << 10, 8) for _ in range(num_intra)]
    return Workload(tuple(background + inter + intra))


def aicb_workload(comm_bytes_per_iter: float, iter_us: float,
                  comm_frac: float, num_flows: int, msg_size: float,
                  concurrency: int = 16, jitter: float = 0.0,
                  seed: int = 0) -> Workload:
    """LLM-training traffic from the AICB-like analytic model
    (``repro_torch.traffic``): each iteration sends ``comm_bytes_per_iter``
    during a comm phase lasting ``comm_frac``·iter. Optional per-flow phase
    jitter, drawn from numpy's ``default_rng(seed)`` as the JAX package
    draws it."""
    rng = np.random.default_rng(seed)
    flows = []
    for i in range(num_flows):
        start = float(rng.uniform(0, jitter * iter_us)) if jitter else 0.0
        flows.append(FlowSpec(True, msg_size, concurrency,
                              start_us=start, period_us=iter_us,
                              duty=comm_frac))
    return Workload(tuple(flows))
