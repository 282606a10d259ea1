"""The paper's Fig. 3 figures and the seven-scheme comparisons through the
port's netsim, on the card.

    PYTHONPATH=src python -m repro_torch.launch.netsim --figure fig3b \
        [--full] [--device cpu] [--horizon-us US] [--profile-steps N] \
        [--checkpoint-dir DIR [--resume]] [--manifest-out JSONL] \
        [--timeline-out JSON] [--out-dir DIR]

The torch twin of ``benchmarks/figures.py`` ``fig3b_throughput``,
``fig3cd_buffer_pause`` and ``fig3e_fct``: the same grids (reduced unless
``--full``), horizons and derived rows (max speedup vs DCQCN, buffer and
pause reduction, FCT improvement), printed as ``name,value,note`` with
``value`` the wall time per cell in us, as ``figures.py`` prints them. Each
scheme's whole grid runs as one ``[B]`` batch (``figures.py`` runs fig3b per
message size; the cells are independent, so the rows are the same).

``--figure scheme_compare`` and ``--figure topology`` are the torch twins of
``benchmarks/scheme_compare.py``'s ``run`` (the seven schemes over 7
distances, 10 with ``--full``, on the congestion workload at the
convergence horizon, at least 30 ms) and ``run_topology_grid`` (the seven
schemes over 3 x 3 delay spreads and capacity skews of three links at
100 km, 4 x 4 with ``--full``, 20 ms), streamed (``trace_mode="metrics"``),
with the same asserts: every scheme's streamed columns present and finite,
and on the topology grid rdmacell's spraying columns with ``spray_entropy``
in [0, 1].

``--figure impairment``, ``sites`` and ``failover`` are the twins of its
``run_impairment_grid`` (the seven schemes over loss_rate x jitter_us at 50
km on the ``impaired`` channel, 6 cells, 15 with ``--full``, 20 ms),
``run_sites_grid`` (the 3-site mesh under ``trace_replay``: relay delay
spread x schedule amplitude, 9 cells, 20 with ``--full``) and
``run_failover_grid`` (three unequal links at 100 km: no outage, link 0 or
the whole site down, for 2 or 4 ms, 6.67 with ``--full``; decimated traces,
``strict_conservation`` armed, ``--checkpoint-dir``/``--resume`` as in
JAX), with their asserts: the channel (or failover) columns present and
finite; sdr_rdma repairing faster than dcqcn (lower p99 repair latency) at
every lossy jitter-free cell where both repair, and the zero-impairment rows
equal to an ideal-channel run of those cells within 1e-6; the replayed
loss biting at full amplitude only; the control rows scoring 0 and a site
outage collapsing more than half the throughput, no less than link 0's.

``--figure obs`` is the twin of ``benchmarks/obs_bench.py``'s ``run_smoke``:
dcqcn and matchrdma at 100 and 300 km on the congestion workload (8 + 8
flows, a burst from 2 to 8 ms), 12 ms, with a 32-slot event ring, as a
window-mode ``sweep_grid`` with a run manifest; its rows must equal a
metrics-mode run's exactly, ``tools/obs_report.py`` must summarize the
manifest and diff it against itself, and a Perfetto timeline of a direct
window-mode batch a scheme must hold PFC events in the dcqcn cells and
``scheme_brake`` events in the matchrdma cells (``manifest.jsonl`` and
``timeline.json`` under ``--out-dir``, default ``build/obs``).

``--manifest-out PATH`` writes, for any figure, one JSONL run manifest of
all the figure's launches (``netsim.obs.profile``; ``tools/obs_report.py``
reads it). ``--timeline-out PATH`` (fig3cd) also exports
``benchmarks/report.py``'s demo timeline: the 100 km congestion scenario
for dcqcn and matchrdma in window mode with a 64-slot event ring, 40 ms
(or ``--horizon-us``), one Perfetto process per scheme.

Per scheme it also prints the wall time (host clock around the runner call,
graph capture included), simulated cell-steps per second, and, on the card,
the device ms per step (CUDA events around the graph replays), the kernels
launched per step (``--profile-steps`` eager steps under
``torch.profiler``) and the device's idle share (one replay of a graph of 20
steps or fewer under the profiler: 1 - kernel time / the replay's span).
``--horizon-us`` cuts every figure's horizon (the rows then differ from the
paper's setup). The last line is JSON. Runs on the GPU unless
``--device cpu``; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import string
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.config.net import NetConfig
from repro_torch.device import resolve_device
from repro_torch.netsim import (
    ALL_SCHEMES, SCHEMES, FailureSchedule, FlowSpec, SiteEdge, SiteGraph,
    Workload, congestion_workload, convergence_horizon_us, mixed_fct_workload,
    run_experiment_batch, simulate, simulate_batch, sweep_grid,
    throughput_workload,
)
from repro_torch.netsim.fluid import build_batch
from repro_torch.netsim.obs import (
    decode_events, export_timeline, read_manifest, timeline_cell,
    timeline_from_window, write_manifest,
)

PROFILE_STEPS = 100
# step_profile takes a trace again if it holds no kernel, at most this often
PROFILE_TRIES = 3

# scheme_compare.py's asserts: the streamed columns of each scheme's rows,
# and rdmacell's columns on every multi-link row
STREAMED_COLS = {
    "dcqcn": ("mean_cc_rate_gbps",),
    "themis": ("mean_cc_rate_gbps",),
    "pseudo_ack": ("mean_pseudo_lead_mb",),
    "matchrdma": ("mean_budget_gbps", "mean_budget_at_src_gbps"),
    "geopipe": ("mean_credit_mb", "credit_stall_frac"),
    "sdr_rdma": ("mean_ack_lag_mb", "mean_retx_reserve_frac"),
    "rdmacell": ("mean_budget_gbps",),
}
TOPOLOGY_COLS = ("mean_reorder_buf_mb", "spray_entropy")
ENTROPY_ROUNDING = 1e-6
# the columns every impairment / sites row and every failover row carries
CHANNEL_COLS = ("goodput_gbps", "wire_gbps", "retx_frac",
                "p99_repair_latency_us")
FAILOVER_COLS = ("failover_collapse_frac", "failover_recovery_us")
# the zero-impairment rows against an ideal-channel run of the same cells
IDEAL_ROW_REL = 1e-6


def kept(template: str, **values) -> tuple:
    """A row's note, ``template`` filled from ``values``, and the numbers it
    prints: ``(note, {field: value}, {field: format spec})`` for each field
    the template names (the other ``values`` are ignored)."""
    fields = [(f, spec) for _, f, spec, _ in string.Formatter().parse(template) if f]
    return (template.format(**values), {f: float(values[f]) for f, _ in fields},
            dict(fields))


class Figure:
    """Runs one figure's batches and keeps each scheme's timing record; with
    ``manifest_out`` each runner call writes a run manifest, merged into one
    at ``manifest_out`` by ``write_manifest``."""

    def __init__(self, name: str, device: torch.device,
                 horizon_us: Optional[float] = None,
                 profile_steps: int = PROFILE_STEPS,
                 manifest_out: Optional[str] = None):
        self.name, self.device = name, device
        self.horizon_us = horizon_us
        self.profile_steps = profile_steps
        self.manifest_out = manifest_out
        self.manifests: List[str] = []
        self.records: List[dict] = []
        # each printed row's numbers, by row name: {"values", "specs"}, and
        # each scheme's rows as the runner gave them
        self.values: dict = {}
        self.batches: dict = {}

    def keep(self, row: str, template: str, **values) -> str:
        """The note of ``row`` (``kept``), its numbers kept in ``values``."""
        note, nums, specs = kept(template, **values)
        self.values[row] = {"values": nums, "specs": specs}
        return note

    def horizon(self, paper_us: float) -> float:
        return paper_us if self.horizon_us is None else self.horizon_us

    def manifest_part(self) -> Optional[str]:
        """The manifest path of the next runner call (None without
        ``manifest_out``)."""
        if self.manifest_out is None:
            return None
        self.manifests.append(f"{self.manifest_out}.part{len(self.manifests)}")
        return self.manifests[-1]

    def write_manifest(self) -> Optional[str]:
        """Merge the calls' manifests into ``manifest_out``: one header (the
        calls' fingerprints hashed together, their launches, cells, schemes
        and times summed) and every call's launch records, each tagged with
        its ``call`` index."""
        if not self.manifests:
            return None
        heads, launches = [], []
        for i, part in enumerate(self.manifests):
            head, recs = read_manifest(part)
            heads.append(head)
            launches += [dict(r, call=i) for r in recs]
            os.remove(part)
        h = hashlib.sha256("".join(hd["fingerprint"] for hd in heads).encode())
        first = heads[0]
        header = {k: first[k] for k in ("backend", "n_devices", "decimate",
                                        "horizon_us", "steps", "warm_steps")}
        modes = sorted({hd["trace_mode"] for hd in heads})
        header.update(
            figure=self.name, calls=len(heads), fingerprint=h.hexdigest(),
            trace_mode=modes[0] if len(modes) == 1 else ",".join(modes),
            schemes=sorted({s for hd in heads for s in hd["schemes"]}),
            **{k: sum(hd[k] for hd in heads)
               for k in ("n_cells", "n_launches", "n_resumed",
                         "total_compile_s", "total_execute_s")})
        self.manifests = []
        return write_manifest(self.manifest_out, header, launches)

    def run(self, cfgs, workload, scheme: str, horizon_us: float,
            trace_mode: str = "full", channel=None, **kw):
        """The rows of one scheme's batch and its wall us per cell; ``kw``
        goes to ``run_experiment_batch`` (decimation, hardening knobs)."""
        launches: list = []
        t0 = time.perf_counter()
        rows = run_experiment_batch(cfgs, workload, scheme, horizon_us,
                                    trace_mode=trace_mode, channel=channel,
                                    device=self.device, profile=launches,
                                    manifest_path=self.manifest_part(), **kw)
        wall_s = time.perf_counter() - t0
        self.record(scheme, len(cfgs), launches, wall_s, cfgs, workload, channel)
        self.batches[scheme] = rows
        return rows, wall_s * 1e6 / len(cfgs)

    def record(self, scheme: str, n_cells: int, launches: list, wall_s: float,
               cfgs, workload, channel=None) -> dict:
        """The timing record of one scheme's batch (its launches' timing
        dicts), with the step profile on the card."""
        if not launches:     # every launch resumed from its checkpoint
            rec = {"figure": self.name, "scheme": scheme, "cells": n_cells,
                   "launches": 0, "resumed": True, "wall_s": wall_s}
            self.records.append(rec)
            return rec
        steps = launches[0]["steps"]
        run_ms = sum(p["run_ms"] for p in launches)
        rec = {"figure": self.name, "scheme": scheme, "cells": n_cells,
               "steps": steps, "launches": len(launches), "wall_s": wall_s,
               "capture_s": sum(p["capture_s"] for p in launches),
               "cell_steps_per_s": n_cells * steps / wall_s}
        # CUDA events on the card, the host clock on the CPU
        rec["device_ms_per_step" if self.device.type == "cuda" else
            "cpu_ms_per_step"] = run_ms / max(steps * len(launches), 1)
        if self.device.type == "cuda" and self.profile_steps > 0:
            rec.update(step_profile(cfgs, workload, scheme, self.device,
                                    self.profile_steps, channel=channel))
        self.records.append(rec)
        return rec


def step_profile(cfgs, workload, scheme: str, device: torch.device,
                 n_steps: int = PROFILE_STEPS,
                 graph_kernels: int = 4096, channel=None) -> dict:
    """Where a step's time goes on the card: ``n_steps`` eager steps of the
    batch under ``torch.profiler`` (kernels launched and kernel ms per step,
    time by kernel), then one replay of a CUDA graph of about
    ``graph_kernels`` kernels (at most 20 steps) under it: the device's idle
    share over the replay, 1 - the kernels' summed time / the span from the
    first kernel's start to the last one's end. Only device activity is
    recorded; a replay of 8,600 kernels (20 matchrdma steps) ran twice as
    long under the profiler as without it, so the replay is kept short. A
    trace that holds no kernel (CUPTI has dropped a whole trace while other
    processes used the card) is taken again, up to ``PROFILE_TRIES`` times;
    if every try is empty, what it would have read is None ("not
    measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced(fn):
        """The device events of fn() under the profiler, the first trace
        of ``PROFILE_TRIES`` that holds any, and how many were empty."""
        for empty in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize(device)
            events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if events:
                return events, empty
        return [], PROFILE_TRIES

    _, state, step = build_batch(cfgs, workload, scheme, device=device,
                                 channel=channel)
    t = torch.zeros((), dtype=torch.int32, device=device)

    def run(state, t, n):
        for _ in range(n):
            state, _ = step(state, t)
            t = t + 1
        return state, t

    state, t = run(state, t, 3)                   # warm-up
    torch.cuda.synchronize(device)
    carry = [state, t]

    def eager_steps():
        carry[:] = run(*carry, n_steps)

    eager, eager_empty = traced(eager_steps)
    state, t = carry
    by_name: dict = {}
    for e in eager:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    graph_steps = max(1, min(20, graph_kernels * n_steps // max(len(eager), 1)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(state, t, graph_steps)
    graph.replay()
    torch.cuda.synchronize(device)
    kernels, graph_empty = traced(graph.replay)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]

    def per_step(x, n, seen):
        return x / n if seen else None

    return {"profiled_steps": n_steps,
            "empty_traces": eager_empty + graph_empty,
            "kernels_per_step": per_step(len(eager), n_steps, eager),
            "kernel_ms_per_step": per_step(
                sum(e.time_range.elapsed_us() for e in eager) / 1e3, n_steps, eager),
            "graph_steps": graph_steps,
            "graph_kernels_per_step": per_step(len(kernels), graph_steps, kernels),
            "graph_kernel_ms_per_step": per_step(busy_us / 1e3, graph_steps, kernels),
            "graph_span_ms_per_step": per_step(span_us / 1e3, graph_steps, kernels),
            "idle_share": (1.0 - busy_us / span_us) if span_us else None,
            "top_kernels": [{"name": k[:80], "count": n, "ms": us / 1e3}
                            for k, (n, us) in top]}


def fmt(x, spec: str) -> str:
    """``x`` in ``spec``, or "not measured" where a profile saw no kernel."""
    return "not measured" if x is None else format(x, spec)


def fig3b_throughput(fig: Figure, full: bool = False):
    """Fig. 3(b): inter-DC throughput vs distance under different message
    sizes. Derived: MatchRDMA/DCQCN speedup (paper: up to 20x)."""
    rows = []
    dists = (1.0, 100.0, 1000.0) if not full else (1.0, 10.0, 50.0, 100.0,
                                                   300.0, 500.0, 1000.0)
    msgs = (64 << 10, 1 << 20) if not full else (1 << 10, 16 << 10, 64 << 10,
                                                 256 << 10, 1 << 20, 8 << 20)
    cfgs = [NetConfig(distance_km=d) for d in dists]
    h = fig.horizon(max(100_000.0,
                        40 * max(c.one_way_delay_us for c in cfgs) + 20_000.0))
    grid = [NetConfig(distance_km=d) for _ in msgs for d in dists]
    wls = [throughput_workload(msg_size=m, concurrency=1, num_flows=4)
           for m in msgs for _ in dists]
    res, us = {}, {}
    for s in SCHEMES:
        res[s], us[s] = fig.run(grid, wls, s, h)
    best_speedup = 0.0
    for j, msg in enumerate(msgs):
        part = {s: res[s][j * len(dists):(j + 1) * len(dists)] for s in SCHEMES}
        for s in SCHEMES:
            for r in part[s]:
                name = (f"fig3b/thr_gbps/{s}/d{int(r['distance_km'])}km/"
                        f"msg{msg >> 10}KB")
                rows.append((name, us[s], fig.keep(name, "{throughput_gbps:.2f}Gbps",
                                                   **r)))
        for i, _ in enumerate(dists):
            sp = (part["matchrdma"][i]["throughput_gbps"]
                  / max(part["dcqcn"][i]["throughput_gbps"], 1e-9))
            best_speedup = max(best_speedup, sp)
    name = "fig3b/max_speedup_vs_dcqcn"
    rows.append((name, 0.0, fig.keep(name, "{speedup:.1f}x (paper: up to 20x)",
                                      speedup=best_speedup)))
    return rows


def fig3cd_buffer_pause(fig: Figure, full: bool = False):
    """Fig. 3(c): destination-OTN runtime buffer; Fig. 3(d): pause ratio."""
    rows = []
    dists = (100.0,) if not full else (10.0, 100.0, 500.0, 1000.0)
    cfgs = [NetConfig(distance_km=d) for d in dists]
    wl = congestion_workload()
    base = {}
    for s in SCHEMES:
        batch, us = fig.run(cfgs, wl, s, fig.horizon(100_000.0))
        for d, r in zip(dists, batch):
            name = f"fig3c/peak_buffer_mb/{s}/d{int(d)}km"
            rows.append((name, us, fig.keep(
                name, "{peak_buffer_mb:.1f}MB p99={p99_buffer_mb:.1f}", **r)))
            name = f"fig3d/pause_ratio/{s}/d{int(d)}km"
            rows.append((name, us, fig.keep(name, "{pause_ratio:.4f}", **r)))
            base[(s, d)] = r
    for d in dists:
        m, dq = base[("matchrdma", d)], base[("dcqcn", d)]

        def reduction(col):
            return -100 * (1 - m[col] / max(dq[col], 1e-9))

        name = f"fig3c/buffer_reduction/d{int(d)}km"
        rows.append((name, 0.0, fig.keep(
            name, "peak {peak_pct:+.1f}% p99 {p99_pct:+.1f}% (paper: -62.7% peak)",
            peak_pct=reduction("peak_buffer_mb"), p99_pct=reduction("p99_buffer_mb"))))
        name = f"fig3d/pause_reduction/d{int(d)}km"
        rows.append((name, 0.0, fig.keep(name, "{pause_pct:+.1f}% (paper: -94.1%)",
                                          pause_pct=reduction("pause_ratio"))))
    return rows


def fig3e_fct(fig: Figure, full: bool = False):
    """Fig. 3(e): mixed-traffic average FCT vs message size; the message-size
    grid varies the workload, so the figure is one scenario batch a scheme."""
    rows = []
    msgs = (64 << 10, 1 << 20, 8 << 20)
    cfgs = [NetConfig(distance_km=100.0)] * len(msgs)
    wls = [mixed_fct_workload(msg_size=msg) for msg in msgs]
    res = {}
    for s in SCHEMES:
        batch, us = fig.run(cfgs, wls, s, fig.horizon(200_000.0))
        res[s] = [r["avg_fct_us"] for r in batch]
        for msg, r in zip(msgs, batch):
            name = f"fig3e/avg_fct_us/{s}/msg{msg >> 10}KB"
            rows.append((name, us, fig.keep(name, "{avg_fct_us:.0f}us", **r)))
    for i, msg in enumerate(msgs):
        imp = 100 * (1 - res["matchrdma"][i] / max(res["dcqcn"][i], 1e-9))
        name = f"fig3e/fct_improvement/msg{msg >> 10}KB"
        rows.append((name, 0.0, fig.keep(
            name, "{fct_pct:+.1f}% vs dcqcn (paper: +31.5..43.9%)", fct_pct=imp)))
    return rows


def compare_workload(horizon_us: float):
    """scheme_compare.py's congestion scenario scaled to the horizon: 4
    inter-DC flows and 4 intra-DC flows bursting through the middle third."""
    return congestion_workload(num_inter=4, num_intra=4,
                               burst_start_us=horizon_us / 3.0,
                               burst_len_us=horizon_us / 3.0,
                               horizon_us=horizon_us)


def _finite(v) -> bool:
    return isinstance(v, float) and math.isfinite(v)


def _check_streamed(name: str, rows: dict, n_cells: int, links: bool = False):
    """scheme_compare.py's row asserts over each scheme's rows."""
    for s, rs in rows.items():
        if len(rs) != n_cells:
            raise AssertionError(f"{name} {s}: {len(rs)} rows, {n_cells} cells")
        cols = STREAMED_COLS[s] + (TOPOLOGY_COLS if links and s == "rdmacell"
                                   else ())
        for col in cols + ("throughput_gbps",):
            bad = [i for i, r in enumerate(rs) if not _finite(r.get(col))]
            if bad:
                raise AssertionError(f"{name} {s}: column {col} missing or not "
                                     f"finite at cells {bad}")
        if links and s == "rdmacell":
            # an even spray reads 1.0000000180537645 here and in the JAX
            # package (the f32 entropy over the f64 log 3): [0, 1] up to f32
            bad = [r["spray_entropy"] for r in rs
                   if not 0.0 <= r["spray_entropy"] <= 1.0 + ENTROPY_ROUNDING]
            if bad:
                raise AssertionError(f"{name}: spray_entropy outside [0, 1]: {bad}")


def scheme_compare(fig: Figure, full: bool = False):
    """scheme_compare.py ``run``: the seven schemes over the distance grid on
    the congestion workload, each scheme's grid one streamed batch.
    Summary rows per scheme: throughput at the farthest distance, the worst
    peak buffer, the mean pause ratio."""
    dists = (1.0, 10.0, 50.0, 100.0, 300.0, 500.0, 1000.0)
    if full:
        dists = dists + (30.0, 700.0, 2000.0)
    cfgs = [NetConfig(distance_km=d) for d in sorted(dists)]
    h = fig.horizon(max(convergence_horizon_us(cfgs), 30_000.0))
    wl = compare_workload(h)
    res, out = {}, []
    for s in ALL_SCHEMES:
        res[s], us = fig.run(cfgs, wl, s, h, trace_mode="metrics")
        for r in res[s]:
            name = f"scheme_compare/{s}/d{r['distance_km']:g}km"
            out.append((name, us, fig.keep(
                name, "thr={throughput_gbps:.4g}Gbps peak={peak_buffer_mb:.4g}MB "
                "mean={mean_buffer_mb:.4g}MB p99={p99_buffer_mb:.4g}MB "
                "pause={pause_ratio:.4g} intra={intra_thr_gbps:.4g}Gbps", **r)))
    _check_streamed("scheme_compare", res, len(cfgs))
    far = max(dists)
    for s, rs in res.items():
        name = f"scheme_compare/summary/{s}"
        out.append((name, 0.0, fig.keep(
            name, "thr@far={thr_far_gbps:.2f}Gbps worst_peak={worst_peak_mb:.2f}MB "
            "mean_pause={mean_pause:.4f}",
            thr_far_gbps=next(r for r in rs if r["distance_km"] == far)["throughput_gbps"],
            worst_peak_mb=max(r["peak_buffer_mb"] for r in rs),
            mean_pause=sum(r["pause_ratio"] for r in rs) / len(rs))))
    return out


def topology(fig: Figure, full: bool = False):
    """scheme_compare.py ``run_topology_grid``: the seven schemes over three
    unequal links at 100 km (delay spread x capacity skew), each scheme's
    grid one streamed batch. Summary rows per scheme: mean throughput and
    worst peak buffer (rdmacell: also the mean spray entropy)."""
    spreads = ((1.0, 1.0, 1.0), (1.0, 1.5, 2.0), (1.0, 2.0, 4.0))
    skews = ((1 / 3, 1 / 3, 1 / 3), (0.5, 0.3, 0.2), (0.6, 0.3, 0.1))
    if full:
        spreads = spreads + ((1.0, 3.0, 6.0),)
        skews = skews + ((0.8, 0.15, 0.05),)
    cells = [(sp, sk) for sp in spreads for sk in skews]
    cfgs = [NetConfig(distance_km=100.0, num_paths=3, path_delay_scale=sp,
                      path_cap_frac=sk) for sp, sk in cells]
    h = fig.horizon(20_000.0)
    wl = compare_workload(h)
    res, out = {}, []
    for s in ALL_SCHEMES:
        res[s], us = fig.run(cfgs, wl, s, h, trace_mode="metrics")
        for (sp, sk), r in zip(cells, res[s]):
            cell = ("x".join(f"{x:g}" for x in sp) + "/"
                    + "x".join(f"{x:.2g}" for x in sk))
            extra = (" rob={mean_reorder_buf_mb:.4g}MB entropy={spray_entropy:.4f}"
                     if "spray_entropy" in r else "")
            name = f"topology/{s}/{cell}"
            out.append((name, us, fig.keep(
                name, "thr={throughput_gbps:.4g}Gbps peak={peak_buffer_mb:.4g}MB "
                "pause={pause_ratio:.4g}" + extra, **r)))
    _check_streamed("topology", res, len(cfgs), links=True)
    for s, rs in res.items():
        extra = {"spray_entropy": sum(r["spray_entropy"] for r in rs) / len(rs)} \
            if s == "rdmacell" else {}
        name = f"topology/summary/{s}"
        out.append((name, 0.0, fig.keep(
            name, "mean_thr={mean_thr_gbps:.2f}Gbps worst_peak={worst_peak_mb:.2f}MB"
            + (" spray_entropy={spray_entropy:.4f}" if extra else ""),
            mean_thr_gbps=sum(r["throughput_gbps"] for r in rs) / len(rs),
            worst_peak_mb=max(r["peak_buffer_mb"] for r in rs), **extra)))
    return out


def _by_scheme(fig: Figure, cfgs, wl, horizon_us: float, cells, label,
               **kw) -> tuple:
    """Each scheme's grid as one batch: ``(rows by scheme, printed rows)``;
    ``cols`` are printed beside the Fig. 3 ones, the rest of ``kw`` goes to
    ``Figure.run``."""
    cols = kw.pop("cols", ())
    res, out = {}, []
    for s in ALL_SCHEMES:
        res[s], us = fig.run(cfgs, wl, s, horizon_us, **kw)
        if len(res[s]) != len(cells):
            raise AssertionError(f"{fig.name} {s}: {len(res[s])} rows, "
                                 f"{len(cells)} cells")
        template = " ".join(f"{k}={{{k}:.4g}}" for k in (
            "throughput_gbps", "peak_buffer_mb", "pause_ratio") + cols)
        for cell, r in zip(cells, res[s]):
            name = f"{fig.name}/{s}/{label(cell)}"
            out.append((name, us, fig.keep(name, template, **r)))
    return res, out


def _check_finite(name: str, res: dict, cols: tuple):
    for s, rs in res.items():
        for col in cols + ("throughput_gbps",):
            bad = [i for i, r in enumerate(rs) if not _finite(r.get(col))]
            if bad:
                raise AssertionError(f"{name} {s}: column {col} missing or not "
                                     f"finite at cells {bad}")


def impairment_cells(full: bool = False) -> tuple:
    """``(cells, configs)`` of the impairment grid: (loss_rate, jitter_us) at
    50 km with ``loss_burst_len`` 4."""
    loss_rates = (0.0, 0.005, 0.02) + ((0.001, 0.05) if full else ())
    jitters = (0.0, 25.0) + ((100.0,) if full else ())
    cells = [(lr, j) for lr in sorted(loss_rates) for j in sorted(jitters)]
    return cells, [NetConfig(distance_km=50.0, loss_rate=lr, loss_burst_len=4.0,
                             jitter_us=j) for lr, j in cells]


def impairment(fig: Figure, full: bool = False):
    """scheme_compare.py ``run_impairment_grid``: the seven schemes over
    loss_rate x jitter_us at 50 km (``loss_burst_len`` 4) on the
    ``impaired`` channel, each scheme's grid one streamed batch. Asserts the
    channel columns, sdr_rdma's lower p99 repair latency than dcqcn at every
    lossy jitter-free cell where both repair (at least one such cell), and
    the zero-impairment rows against an ideal-channel run of those cells.
    Summary rows per scheme: the cell with the largest retx_frac."""
    cells, cfgs = impairment_cells(full)
    h = fig.horizon(20_000.0)
    wl = compare_workload(h)
    res, out = _by_scheme(fig, cfgs, wl, h, cells,
                          lambda c: f"loss{c[0]:g}/jitter{c[1]:g}us",
                          trace_mode="metrics", channel="impaired",
                          cols=CHANNEL_COLS)
    _check_finite("impairment", res, CHANNEL_COLS)
    compared = 0
    for i, (lr, j) in enumerate(cells):
        dc = res["dcqcn"][i]["p99_repair_latency_us"]
        sdr = res["sdr_rdma"][i]["p99_repair_latency_us"]
        if lr > 0 and j == 0.0 and dc > 0 and sdr > 0:
            if not sdr < dc:
                raise AssertionError(f"impairment loss {lr}: sdr_rdma p99 repair "
                                     f"latency {sdr} us not below dcqcn's {dc} us")
            compared += 1
    if not compared:
        raise AssertionError("impairment: no lossy cell produced pending repairs "
                             "to compare")
    # the channel is invisible at its defaults
    zero = [i for i, (lr, j) in enumerate(cells) if lr == 0 and j == 0]
    for s in ALL_SCHEMES:
        ideal = run_experiment_batch([cfgs[i] for i in zero], wl, s, h,
                                     trace_mode="metrics", device=fig.device)
        for i, b in zip(zero, ideal):
            a = res[s][i]
            for m in ("throughput_gbps", "mean_buffer_mb", "pause_ratio"):
                if abs(a[m] - b[m]) > IDEAL_ROW_REL * max(abs(a[m]), abs(b[m]), 1.0):
                    raise AssertionError(f"impairment {s}: zero-impairment {m} "
                                         f"{a[m]} vs the ideal channel's {b[m]}")
    for s, rs in res.items():
        w = max(rs, key=lambda r: r["retx_frac"])
        name = f"impairment/summary/{s}"
        out.append((name, 0.0, fig.keep(
            name, "goodput_worst={goodput_worst_gbps:.2f}Gbps "
            "retx_frac_worst={retx_frac_worst:.4f} "
            "p99_repair_worst={p99_repair_worst_us:.1f}us",
            goodput_worst_gbps=w["goodput_gbps"], retx_frac_worst=w["retx_frac"],
            p99_repair_worst_us=w["p99_repair_latency_us"])))
    return out


# the 3-site mesh of the sites grid: a bundled primary pair (two parallel
# 0->1 edges) plus a relay path through site 2 (scheme_compare.SITES_EDGES)
SITES_EDGES = (SiteEdge(0, 1), SiteEdge(0, 1, delay_scale=1.5),
               SiteEdge(0, 2, cap_frac=0.2), SiteEdge(2, 1, cap_frac=0.2))


def sites_workload(horizon_us: float) -> Workload:
    """scheme_compare._sites_workload: inter-DC load on all three site pairs
    and an intra-DC burst at site 1's leaf through the middle third."""
    inter = [FlowSpec(True, 1 << 20, 16) for _ in range(2)]
    inter += [FlowSpec(True, 1 << 20, 16, src_site=0, dst_site=2),
              FlowSpec(True, 1 << 20, 16, src_site=2, dst_site=1)]
    intra = [FlowSpec(False, 256 << 10, 8, dst_site=1, start_us=horizon_us / 3.0,
                      period_us=horizon_us, duty=1.0 / 3.0) for _ in range(2)]
    return Workload(tuple(inter + intra))


def sites_schedule(scale: float, k: int = 8) -> tuple:
    """scheme_compare._sites_schedule: the mesh's per-edge timeline scaled by
    ``scale`` (a loss burst on the primary edge, a capacity dip on its
    sibling, loss and deferral on the relay uplink, a clean downlink)."""
    def edge(loss_peak=0.0, defer_peak=0.0, cap_dip=0.0, slot=3):
        loss, defer, cap = [0.0] * k, [0.0] * k, [1.0] * k
        loss[slot] = loss_peak * scale
        defer[slot] = defer_peak * scale
        cap[(slot + 2) % k] = 1.0 - cap_dip * scale
        return tuple(zip(loss, defer, cap))
    return (edge(loss_peak=0.3), edge(cap_dip=0.6),
            edge(loss_peak=0.1, defer_peak=0.4), edge())


def sites_cells(horizon_us: float, full: bool = False) -> tuple:
    """``(cells, configs)`` of the sites grid: (relay delay spread, schedule
    amplitude) on the mesh at 100 km, one schedule slot an eighth of the
    horizon."""
    spreads = (1.0, 1.5, 2.5) + ((4.0,) if full else ())
    scales = (0.0, 0.5, 1.0) + ((0.25, 0.75) if full else ())
    cells = [(sp, sc) for sp in spreads for sc in sorted(scales)]
    base = NetConfig(distance_km=100.0, channel_schedule_dt_us=horizon_us / 8.0)
    cfgs = []
    for sp, sc in cells:
        g = SiteGraph(3, SITES_EDGES[:2] + tuple(
            dataclasses.replace(e, delay_scale=sp) for e in SITES_EDGES[2:]))
        cfgs.append(dataclasses.replace(g.to_net_config(base),
                                        channel_schedule=sites_schedule(sc)))
    return cells, cfgs


def sites(fig: Figure, full: bool = False):
    """scheme_compare.py ``run_sites_grid``: the seven schemes over the 3-site
    mesh at 100 km under ``trace_replay``, relay delay spread x schedule
    amplitude, each scheme's grid one streamed batch. Asserts the channel
    columns and that dcqcn's replayed loss bites at amplitude 1 and not at
    0. Summary rows per scheme: mean throughput and the cell with the
    largest retx_frac."""
    h = fig.horizon(20_000.0)
    cells, cfgs = sites_cells(h, full)
    res, out = _by_scheme(fig, cfgs, sites_workload(h), h, cells,
                          lambda c: f"spread{c[0]:g}/scale{c[1]:g}",
                          trace_mode="metrics", channel="trace_replay",
                          cols=CHANNEL_COLS)
    _check_finite("sites", res, CHANNEL_COLS)
    for i, (sp, sc) in enumerate(cells):
        retx = res["dcqcn"][i]["retx_frac"]
        if (sc == 0.0 and retx != 0.0) or (sc == 1.0 and not retx > 0.0):
            raise AssertionError(f"sites spread {sp} scale {sc}: dcqcn retx_frac "
                                 f"{retx}")
    for s, rs in res.items():
        w = max(rs, key=lambda r: r["retx_frac"])
        name = f"sites/summary/{s}"
        out.append((name, 0.0, fig.keep(
            name, "mean_thr={mean_thr_gbps:.2f}Gbps goodput_worst={goodput_worst_gbps:.2f}Gbps "
            "retx_frac_worst={retx_frac_worst:.4f}",
            mean_thr_gbps=sum(r["throughput_gbps"] for r in rs) / len(rs),
            goodput_worst_gbps=w["goodput_gbps"], retx_frac_worst=w["retx_frac"])))
    return out


def failover_cells(horizon_us: float, full: bool = False) -> tuple:
    """``(cells, configs)`` of the failover grid: {none, link0, site} x
    outage length, three links at 100 km with capacities 0.5 / 0.3 / 0.2,
    every cell one window per edge (no-op windows on the controls) so the
    window count is the grid's."""
    t_down = horizon_us / 3.0
    durations = (horizon_us / 10.0, horizon_us / 5.0) + (
        (horizon_us / 3.0,) if full else ())
    edge_pairs = ((0, 1),) * 3

    def schedule(kind: str, dur: float) -> FailureSchedule:
        if kind == "link0":
            return FailureSchedule(3).link_outage(0, t_down, t_down + dur)
        if kind == "site":
            return FailureSchedule(3).site_outage(1, t_down, t_down + dur, edge_pairs)
        return FailureSchedule(3, (((0.0, 0.0),),) * 3)

    cells = [(k, d) for k in ("none", "link0", "site") for d in durations]
    base = NetConfig(distance_km=100.0, num_paths=3, path_cap_frac=(0.5, 0.3, 0.2))
    return cells, [schedule(k, d).apply(base) for k, d in cells]


def failover(fig: Figure, full: bool = False, checkpoint_dir=None,
             resume: bool = False):
    """scheme_compare.py ``run_failover_grid``: the seven schemes over the
    outage grid (``failover_cells``), each scheme's grid one batch of
    decimated traces (``decimate=4``) with ``strict_conservation`` armed and
    optional per-launch checkpoints. Asserts the failover columns, the
    controls scoring 0, and a site outage collapsing dcqcn's throughput by
    more than half and no less than link 0's outage of the same length.
    Summary rows per scheme: the worst collapse and recovery."""
    h = fig.horizon(20_000.0)
    cells, cfgs = failover_cells(h, full)
    res, out = _by_scheme(fig, cfgs, compare_workload(h), h, cells,
                          lambda c: f"{c[0]}/{c[1]:g}us", trace_mode="decimate",
                          decimate=4, strict_conservation=True,
                          checkpoint_dir=checkpoint_dir, resume=resume,
                          cols=FAILOVER_COLS)
    _check_finite("failover", res, FAILOVER_COLS)
    for s, rs in res.items():
        for (kind, dur), r in zip(cells, rs):
            ok = (0.0 <= r["failover_collapse_frac"] <= 1.0
                  and r["failover_recovery_us"] >= 0.0)
            if kind == "none":
                ok = ok and r["failover_collapse_frac"] == 0.0 \
                    and r["failover_recovery_us"] == 0.0
            if not ok:
                raise AssertionError(f"failover {s} {kind} {dur}: {r}")
    for i, (kind, dur) in enumerate(cells):
        if kind == "site":
            site = res["dcqcn"][i]["failover_collapse_frac"]
            link = res["dcqcn"][cells.index(("link0", dur))]["failover_collapse_frac"]
            if not (site > 0.5 and site >= link - 1e-9):
                raise AssertionError(f"failover {dur} us: site collapse {site}, "
                                     f"link 0's {link}")
    for s, rs in res.items():
        down = [r for r, (k, _) in zip(rs, cells) if k != "none"]
        name = f"failover/summary/{s}"
        out.append((name, 0.0, fig.keep(
            name, "collapse_worst={collapse_worst:.4f} "
            "recovery_worst={recovery_worst_us:.1f}us mean_thr={mean_thr_gbps:.2f}Gbps",
            collapse_worst=max(r["failover_collapse_frac"] for r in down),
            recovery_worst_us=max(r["failover_recovery_us"] for r in down),
            mean_thr_gbps=sum(r["throughput_gbps"] for r in rs) / len(rs))))
    return out


# benchmarks/obs_bench.py's smoke grid: the event ring's slots and horizon
OBS_SLOTS = 32
OBS_H_US = 12_000.0
OBS_SCHEMES = ("dcqcn", "matchrdma")
# benchmarks/report.py's export_demo_timeline: slots and horizon
DEMO_TIMELINE_SLOTS = 64
DEMO_TIMELINE_H_US = 40_000.0
REPO = Path(__file__).resolve().parents[3]
OBS_REPORT = REPO / "tools" / "obs_report.py"
OBS_OUT = REPO / "build" / "obs"


def obs_report(*args: str) -> str:
    """``tools/obs_report.py`` (the stdlib-only manifest tool of the
    checkout) run on ``args``; its standard output."""
    if not OBS_REPORT.is_file():
        raise FileNotFoundError(f"{OBS_REPORT}: run from a checkout of the repository")
    proc = subprocess.run([sys.executable, str(OBS_REPORT), *args],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"obs_report {args}: {proc.stderr}")
    return proc.stdout


def obs_grid():
    """The obs smoke grid: 100 and 300 km with the event ring, the
    congestion workload of 8 + 8 flows bursting from 2 to 8 ms."""
    cfgs = [dataclasses.replace(NetConfig(distance_km=d), event_ring_slots=OBS_SLOTS)
            for d in (100.0, 300.0)]
    wl = congestion_workload(num_inter=8, num_intra=8, burst_start_us=2_000.0,
                             burst_len_us=6_000.0, horizon_us=OBS_H_US)
    return cfgs, wl


def obs(fig: Figure, full: bool = False, out_dir: Optional[str] = None):
    """benchmarks/obs_bench.py ``run_smoke``: a window-mode ``sweep_grid``
    of dcqcn and matchrdma with a run manifest, its rows equal to a
    metrics-mode run's exactly, the manifest summarised and diffed (against
    itself) by ``tools/obs_report.py``, and a Perfetto timeline from a
    direct window-mode ``simulate_batch`` a scheme, which must hold PFC
    events in the dcqcn cells and ``scheme_brake`` events in the matchrdma
    cells. ``out_dir`` (default ``build/obs`` in the checkout) receives
    ``timeline.json`` and, unless the figure has a ``manifest_out``,
    ``manifest.jsonl``."""
    out_dir = out_dir or str(OBS_OUT)
    os.makedirs(out_dir, exist_ok=True)
    cfgs, wl = obs_grid()
    manifest_path = fig.manifest_out or os.path.join(out_dir, "manifest.jsonl")
    timeline_path = os.path.join(out_dir, "timeline.json")

    # 1. window-mode sweep with a manifest; rows equal to metrics mode's
    launches: list = []
    t0 = time.perf_counter()
    rows_w = sweep_grid(cfgs, wl, OBS_SCHEMES, OBS_H_US, trace_mode="window",
                        manifest_path=manifest_path, device=fig.device,
                        profile=launches)
    window_s = time.perf_counter() - t0
    for s, launch in zip(OBS_SCHEMES, launches):
        fig.record(s, len(cfgs), [launch], launch["wall_s"], cfgs, wl)
    rows_m = sweep_grid([dataclasses.replace(c, event_ring_slots=0) for c in cfgs],
                        wl, OBS_SCHEMES, OBS_H_US, trace_mode="metrics",
                        device=fig.device)
    for a, b in zip(rows_w, rows_m):
        for k in a:
            if not (a[k] == b[k] or (a[k] != a[k] and b[k] != b[k])):
                raise AssertionError(f"window/metrics row divergence at {k}: "
                                     f"{a[k]} != {b[k]}")

    # 2. the manifest through tools/obs_report.py
    header, recs = read_manifest(manifest_path)
    if header.get("record") != "header" or not header.get("fingerprint"):
        raise AssertionError(f"manifest header: {header}")
    if len(recs) != len(OBS_SCHEMES) or not all(
            "execute_s" in r and "compile_s" in r for r in recs):
        raise AssertionError(f"manifest launches: {recs}")
    summary = obs_report("summarize", manifest_path)
    if "totals:" not in summary:
        raise AssertionError(f"obs_report summarize: {summary}")
    diff = obs_report("diff", manifest_path, manifest_path)
    if f"matched launches: {len(recs)}" not in diff:
        raise AssertionError(f"obs_report diff: {diff}")

    # 3. a timeline from a direct window-mode batch a scheme
    steps = cfgs[0].horizon_steps(OBS_H_US)
    merged = {"traceEvents": [], "displayTimeUnit": "ms"}
    kinds = {}
    for i, s in enumerate(OBS_SCHEMES):
        _, aux = simulate_batch(cfgs, wl, s, OBS_H_US, trace_mode="window",
                                device=fig.device)
        kinds[s] = sorted({e["kind"] for c in range(len(cfgs))
                           for e in decode_events(aux.events, OBS_SLOTS, cell=c)})
        doc = timeline_from_window(
            aux, dt_us=cfgs[0].dt_us, steps=steps,
            window_steps=cfgs[0].trace_window_steps, event_ring_slots=OBS_SLOTS,
            labels=[f"{s} @ {c.distance_km:.0f}km" for c in cfgs])
        merged["traceEvents"] += [dict(r, pid=r["pid"] + i * len(cfgs))
                                  for r in doc["traceEvents"]]
    export_timeline(timeline_path, merged)
    with open(timeline_path) as f:
        loaded = json.load(f)
    instants = [r for r in loaded["traceEvents"] if r.get("ph") == "i"]
    if "pfc_xoff" not in kinds["dcqcn"] or "scheme_brake" not in kinds["matchrdma"]:
        raise AssertionError(f"event kinds by scheme: {kinds}")
    names = {r["name"] for r in instants}
    if not {"pfc_xoff", "scheme_brake"} <= names:
        raise AssertionError(f"timeline instant events: {sorted(names)}")
    n_counter = sum(1 for r in loaded["traceEvents"] if r.get("ph") == "C")
    mem = " ".join(f"{r['scheme']}:args={r['argument_size_in_bytes']},"
                   f"temp={r['temp_size_in_bytes']},out={r['output_size_in_bytes']}"
                   for r in recs if "temp_size_in_bytes" in r)
    return [("obs/window_rows_equal_metrics", window_s * 1e6 / len(cfgs),
             f"{len(rows_w)} rows"),
            ("obs/manifest", 0.0, f"{manifest_path}: {len(recs)} launches, "
             f"compile {header['total_compile_s']:.3f}s execute "
             f"{header['total_execute_s']:.3f}s{' bytes ' + mem if mem else ''}"),
            ("obs/event_kinds", 0.0, " ".join(f"{s}:{'|'.join(k)}"
                                             for s, k in kinds.items())),
            ("obs/timeline", 0.0, f"{timeline_path}: {n_counter} counter and "
             f"{len(instants)} instant events")]


def demo_timeline(path: str, device: torch.device,
                  horizon_us: float = DEMO_TIMELINE_H_US) -> int:
    """benchmarks/report.py ``export_demo_timeline``: the 100 km congestion
    scenario per scheme (dcqcn, matchrdma) under ``trace_mode="window"``
    with a 64-slot event ring, as one Perfetto document (a process per
    scheme). Returns the number of trace events written."""
    cfg = dataclasses.replace(NetConfig(distance_km=100.0),
                              event_ring_slots=DEMO_TIMELINE_SLOTS)
    wl = congestion_workload()
    steps = cfg.horizon_steps(horizon_us)
    recs = []
    for pid, scheme in enumerate(OBS_SCHEMES):
        _, aux = simulate(cfg, wl, scheme, horizon_us, trace_mode="window",
                          device=device)
        recs.extend(timeline_cell(
            pid, label=f"{scheme} @ 100km congestion", dt_us=cfg.dt_us,
            steps=steps, window_steps=cfg.trace_window_steps,
            window=dict(aux.window),
            events=decode_events(aux.events, DEMO_TIMELINE_SLOTS)))
    export_timeline(path, {"traceEvents": recs, "displayTimeUnit": "ms"})
    return len(recs)


FIGURES = {"fig3b": fig3b_throughput, "fig3cd": fig3cd_buffer_pause,
           "fig3e": fig3e_fct, "scheme_compare": scheme_compare,
           "topology": topology, "impairment": impairment, "sites": sites,
           "failover": failover, "obs": obs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--figure", default="fig3b", choices=sorted(FIGURES))
    ap.add_argument("--full", action="store_true",
                    help="the complete grid (default: the reduced one)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--horizon-us", type=float, default=None,
                    help="cut every batch's horizon to this (default: the "
                         "paper's)")
    ap.add_argument("--profile-steps", type=int, default=PROFILE_STEPS,
                    help="eager steps profiled per scheme on the card (0: none)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="failover: one JSON checkpoint per finished launch")
    ap.add_argument("--resume", action="store_true",
                    help="failover: load finished launches from --checkpoint-dir")
    ap.add_argument("--manifest-out", default=None, metavar="JSONL",
                    help="write the figure's run manifest (launches, capture "
                         "and replay times, device memory) for "
                         "tools/obs_report.py")
    ap.add_argument("--timeline-out", default=None, metavar="JSON",
                    help="fig3cd: also export the 100 km congestion scenario's "
                         "window-mode Perfetto timeline (dcqcn, matchrdma)")
    ap.add_argument("--out-dir", default=None,
                    help="obs: artifact directory (default: build/obs)")
    args = ap.parse_args(argv)
    if (args.checkpoint_dir or args.resume) and args.figure != "failover":
        ap.error("--checkpoint-dir/--resume go with --figure failover")
    if args.timeline_out and args.figure != "fig3cd":
        ap.error("--timeline-out goes with --figure fig3cd")
    if args.out_dir and args.figure != "obs":
        ap.error("--out-dir goes with --figure obs")

    dev = resolve_device(args.device)
    fig = Figure(args.figure, dev, args.horizon_us, args.profile_steps,
                 manifest_out=args.manifest_out)
    kw = ({"checkpoint_dir": args.checkpoint_dir, "resume": args.resume}
          if args.figure == "failover" else
          {"out_dir": args.out_dir} if args.figure == "obs" else {})
    rows = FIGURES[args.figure](fig, args.full, **kw)
    if args.manifest_out:
        fig.write_manifest()
        rows.append(("manifest", 0.0, args.manifest_out))
    if args.timeline_out:
        n = demo_timeline(args.timeline_out, dev, fig.horizon(DEMO_TIMELINE_H_US))
        rows.append(("timeline", 0.0, f"{args.timeline_out} ({n} trace events)"))
    for name, value, note in rows:
        print(f"{name},{value:.1f},{note}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for r in fig.records:
        if r.get("resumed"):
            print(f"{r['figure']} {r['scheme']}: {r['cells']} cells resumed from "
                  f"checkpoints", flush=True)
            continue
        line = (f"{r['figure']} {r['scheme']}: {r['cells']} cells x "
                f"{r['steps']} steps, wall {r['wall_s']:.2f} s, "
                f"{r['cell_steps_per_s']:.0f} cell-steps/s")
        if "idle_share" in r:
            line += (f", device {r['device_ms_per_step']:.4f} ms/step, "
                     f"{fmt(r['kernels_per_step'], '.0f')} kernels/step "
                     f"({fmt(r['kernel_ms_per_step'], '.4f')} ms), idle "
                     f"{fmt(r['idle_share'], '.1%')}")
        print(line + f" [{kind}]", flush=True)
    out = {"figure": args.figure, "full": args.full, "device": kind,
           "horizon_us": args.horizon_us, "rows": rows, "schemes": fig.records,
           "values": fig.values}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
