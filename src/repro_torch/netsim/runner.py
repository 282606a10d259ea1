"""Experiment runner: simulate + extract the paper's Fig. 3 metrics.

The torch twin of the JAX package's ``netsim/runner.py`` on the Fig. 3 path.
Every grid, heterogeneous configs AND workloads (``Scenario``), runs through
a launch plan: the scenario axis is stacked once, split into equal chunks
(sized so a launch's trace block stays in bounded memory) and each
(scheme, chunk) pair is one ``simulate_batch`` call of a ``[B]`` batch. The
last chunk is padded by repeating its final cell; the padding rows are
dropped.

Execution modes (``trace_mode``):
  * ``full``     ``[B, T]`` traces; metrics from one vectorized numpy pass.
  * ``decimate`` every k-th step; same extractor.
  * ``metrics``  no per-step array: the Fig. 3 reductions are streamed
                 (``MetricAcc``) and only O(B) values reach the host; schemes
                 add their own columns through ``Scheme.finalize_metrics``.

Multi-link and multi-site grids (``num_paths > 1``, site graphs) run like
any other; rdmacell adds its spraying columns there. The JAX runner's
hardening knobs (checkpoints and resume, the finite guard, strict
conservation, crash injection, run manifests) and its channel and failover
columns are not ported: asking for one raises ``NotImplementedError``
naming ROADMAP queue 1 item 15 (or 13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.net import NetConfig, batch_template
from repro_torch.device import resolve_device
from repro_torch.netsim.fluid import (
    STREAM_MAX_KEYS, STREAM_SUM_KEYS, WARMUP_FRAC, batch_padding,
    check_main_path, is_unfinished, simulate_batch,
)
from repro_torch.netsim.schemes import get_scheme
from repro_torch.netsim.streaming import hist_quantile
from repro_torch.netsim.workload import (
    Workload, WorkloadParams, as_workload_batch, is_unbounded,
)

# Auto-chunk targets of the launch plan: a full-trace launch keeps its
# materialized [B_chunk, T] block under ~256 MB of f32 (and, on the card,
# under a sixteenth of the free device memory); a streaming launch is O(B)
# anyway and only caps per-launch host-row cost.
MAX_TRACE_FLOATS = 64 * 1024 * 1024
METRICS_CHUNK_CELLS = 4096
_TRACE_KEYS_EST = 12        # 8 engine trace keys + scheme extras (estimate)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the scenario axis: a network config AND its workload."""
    net: NetConfig
    workload: Workload


# ---------------------------------------------------------------------------
# Metric extraction (batch-wide; the one copy of the Fig. 3 metric set)
# ---------------------------------------------------------------------------


def _flow_metrics(wl: WorkloadParams, final_np: dict):
    """[B] goodput / avg-FCT / completion from the final state and the
    workload leaves. Padded flows carry ``is_inter == 0`` and
    ``total_bytes == 0`` and drop out of every mask."""
    is_inter = np.asarray(wl.is_inter) > 0                         # [B, F]
    delivered = final_np["delivered"]
    goodput = np.where(is_inter, delivered, 0.0).sum(axis=1)

    total = np.asarray(wl.total_bytes)
    start = np.asarray(wl.start_us)
    done_at = final_np["done_at_us"]
    finite = is_inter & ~is_unbounded(total)                       # [B, F]
    fct = done_at - start
    completed = finite & ~is_unfinished(done_at)
    n_finite = finite.sum(axis=1)
    n_completed = completed.sum(axis=1)
    sum_fct = np.where(completed, fct, 0.0).sum(axis=1)
    avg_fct = np.where(n_completed > 0,
                       sum_fct / np.maximum(n_completed, 1), np.inf)
    avg_fct = np.where(n_finite > 0, avg_fct, np.nan)
    completion = np.where(n_finite > 0,
                          n_completed / np.maximum(n_finite, 1), 1.0)
    return goodput, avg_fct, completion


def _assemble_rows(cfgs: Sequence[NetConfig], scheme_name: str, cols: dict,
                   extra: Optional[dict] = None) -> List[Dict[str, float]]:
    """[B]-column dicts -> the per-cell row list of a sweep."""
    rows = []
    for i, cfg in enumerate(cfgs):
        row = {"scheme": scheme_name, "distance_km": cfg.distance_km}
        row.update({k: float(v[i]) for k, v in cols.items()})
        if extra:
            row.update({k: float(np.asarray(v)[i]) for k, v in extra.items()})
        rows.append(row)
    return rows


def _metrics_batch(cfgs: Sequence[NetConfig], wl: WorkloadParams,
                   scheme_name: str, final_np: dict,
                   traces_np: dict) -> List[Dict[str, float]]:
    """Fig. 3 metric set from materialized [B, T] traces in one vectorized
    pass (``trace_mode="full"``/``"decimate"``)."""
    steps = traces_np["q_dst"].shape[1]
    warm = int(steps * WARMUP_FRAC)
    q_dst = traces_np["q_dst"]
    goodput, avg_fct, completion = _flow_metrics(wl, final_np)
    cols = {
        "throughput_gbps":
            traces_np["thr_inter"][:, warm:].mean(axis=1) * 8.0 / 1e9,
        "goodput_bytes": goodput,
        "peak_buffer_mb": q_dst.max(axis=1) / 1e6,
        "mean_buffer_mb": q_dst[:, warm:].mean(axis=1) / 1e6,
        "p99_buffer_mb": np.percentile(q_dst[:, warm:], 99, axis=1) / 1e6,
        "pause_ratio": traces_np["pause_dst"][:, warm:].mean(axis=1),
        "avg_fct_us": avg_fct,
        "completion_frac": completion,
        "intra_thr_gbps":
            traces_np["thr_intra"][:, warm:].mean(axis=1) * 8.0 / 1e9,
    }
    return _assemble_rows(cfgs, scheme_name, cols)


def _metrics_streaming(cfgs: Sequence[NetConfig], wl: WorkloadParams, scheme,
                       final_np: dict, acc, steps: int,
                       warm: int) -> List[Dict[str, float]]:
    """The same Fig. 3 metric set from the O(B) streamed accumulators
    (``trace_mode="metrics"``). p99 inverts the fixed-bin log-histogram
    (bounded relative error); everything else is exact up to summation
    order."""
    n_warm = max(steps - warm, 1)
    sum_s = acc.sum_s.detach().cpu().numpy().astype(np.float64)
    sums = {k: sum_s[:, i] for i, k in enumerate(STREAM_SUM_KEYS)}
    goodput, avg_fct, completion = _flow_metrics(wl, final_np)
    cols = {
        "throughput_gbps": sums["thr_inter"] / n_warm * 8.0 / 1e9,
        "goodput_bytes": goodput,
        "peak_buffer_mb":
            acc.maxes[:, STREAM_MAX_KEYS.index("q_dst")].cpu().numpy() / 1e6,
        "mean_buffer_mb": sums["q_dst"] / n_warm / 1e6,
        "p99_buffer_mb": hist_quantile(acc.hist.cpu().numpy(), 0.99) / 1e6,
        "pause_ratio": sums["pause_dst"] / n_warm,
        "avg_fct_us": avg_fct,
        "completion_frac": completion,
        "intra_thr_gbps": sums["thr_intra"] / n_warm * 8.0 / 1e9,
    }
    extra = scheme.finalize_metrics(
        {k: v.cpu().numpy() for k, v in acc.scheme.items()}, steps, n_warm)
    return _assemble_rows(cfgs, scheme.name, cols, extra)


# ---------------------------------------------------------------------------
# The launch plan: (scheme x chunk) launches over a stacked grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Launch:
    """One launch of a sweep's plan: ``scheme`` over grid cells [lo, hi),
    padded up to ``pad_to`` cells (padding rows are dropped)."""
    scheme: object
    lo: int
    hi: int
    pad_to: int


def _trace_float_budget(device: torch.device) -> int:
    """f32 values one full-trace launch may materialize: ``MAX_TRACE_FLOATS``,
    and on the card at most a sixteenth of the free device memory."""
    if device.type != "cuda":
        return MAX_TRACE_FLOATS
    free, _ = torch.cuda.mem_get_info(device)
    return max(min(MAX_TRACE_FLOATS, free // (4 * 16)), 1)


def chunk_cells(steps: int, trace_mode: str = "full", decimate: int = 1,
                chunk_cells: Optional[int] = None,
                device: Optional[torch.device] = None,
                num_links: int = 1) -> int:
    """Scenario cells per launch: the explicit ``chunk_cells`` override, or
    the bounded-memory auto size (full/decimate: the materialized trace
    block stays under the trace-float budget of ``device``, counting the
    three ``[L]`` trace keys of a multi-link grid; metrics: the flat
    ``METRICS_CHUNK_CELLS`` ceiling)."""
    if chunk_cells is None:
        if trace_mode == "metrics":
            chunk_cells = METRICS_CHUNK_CELLS
        else:
            t = max(steps // max(decimate, 1), 1)
            # q_dst_link / link_tx / link_pause are [L] per step at L > 1
            keys = _TRACE_KEYS_EST + (3 * num_links if num_links > 1 else 0)
            budget = _trace_float_budget(device or torch.device("cpu"))
            chunk_cells = max(budget // (t * keys), 1)
    return max(int(chunk_cells), 1)


# inside run_experiment_batch / sweep_grid the ``chunk_cells`` KEYWORD
# shadows the module-level function
_auto_chunk_cells = chunk_cells


def _plan_launches(n_cells: int, schemes: Sequence, chunk: int) -> List[_Launch]:
    """Flatten (scheme x chunk) into the launch list; every launch pads to
    the plan's chunk size so all share one set of ring sizes."""
    pad_to = min(chunk, n_cells)
    return [_Launch(s, lo, min(lo + chunk, n_cells), pad_to)
            for s in schemes for lo in range(0, n_cells, chunk)]


def _pad_chunk(cfgs, wlp: WorkloadParams, n: int):
    """Pad a trailing chunk to ``n`` cells by repeating its last cell."""
    pad = n - len(cfgs)
    if pad <= 0:
        return cfgs, wlp
    wlp = WorkloadParams(*(np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                           for v in wlp))
    return list(cfgs) + [cfgs[-1]] * pad, wlp


def _grid_static(cfgs, horizon_us, delay_pad: int, history_slots: int):
    """The grid-wide static quantities every launch of a plan shares
    (horizon, scan length, warm cutoff, ring paddings), computed ONCE over
    the whole grid so chunks never re-derive them from their sub-grid."""
    dp, hs = batch_padding(cfgs)
    horizon = (horizon_us if horizon_us is not None
               else max(c.horizon_us for c in cfgs))
    steps = batch_template(cfgs).horizon_steps(horizon)
    return (horizon, steps, int(steps * WARMUP_FRAC),
            max(delay_pad, dp), max(history_slots, hs))


def _run_launch(launch: _Launch, cfgs, wlp: WorkloadParams, grid_static,
                period_slots, trace_mode, decimate, device,
                profile: Optional[list]) -> List[dict]:
    """One launch -> its real cells' rows (grid order); its timings are
    appended to ``profile`` when given."""
    horizon, steps, warm, delay_pad, history_slots = grid_static
    sub_cfgs = cfgs[launch.lo:launch.hi]
    sub_wlp = WorkloadParams(*(v[launch.lo:launch.hi] for v in wlp))
    n_real = len(sub_cfgs)
    sub_cfgs, sub_wlp = _pad_chunk(sub_cfgs, sub_wlp, launch.pad_to)
    kw = {}
    if profile is not None:
        kw["profile"] = {"scheme": launch.scheme.name, "real_cells": n_real}
        profile.append(kw["profile"])
    final, aux = simulate_batch(
        sub_cfgs, sub_wlp, launch.scheme, horizon, period_slots,
        trace_mode=trace_mode, decimate=decimate, delay_pad=delay_pad,
        history_slots=history_slots, warm_steps=warm, device=device, **kw)
    final_np = {"delivered": final.delivered.cpu().numpy(),
                "done_at_us": final.done_at_us.cpu().numpy()}
    if trace_mode == "metrics":
        rows = _metrics_streaming(sub_cfgs, sub_wlp, launch.scheme, final_np,
                                  aux, steps, warm)
    else:
        traces_np = {k: v.cpu().numpy() for k, v in aux.items()}
        rows = _metrics_batch(sub_cfgs, sub_wlp, launch.scheme.name, final_np,
                              traces_np)
    return rows[:n_real]


# the JAX runner's hardening knobs, at their off values
_HARDENING_OFF = {"checkpoint_dir": None, "resume": False,
                  "on_nonfinite": "keep", "strict_conservation": False,
                  "conservation_tol": 1e-3, "abort_after_launches": None,
                  "manifest_path": None}


def _check_unported(cfgs, channel, trace_mode, decimate, devices, knobs: dict):
    unknown = sorted(set(knobs) - set(_HARDENING_OFF))
    if unknown:
        raise TypeError(f"unexpected keyword arguments {unknown}")
    for c in cfgs:
        check_main_path(c, channel, trace_mode, decimate)
    if devices is not None:
        raise NotImplementedError(
            "devices=: sharding a grid over several devices comes with ROADMAP "
            "queue 1 item 17; pass device= for the one device to run on")
    on = sorted(k for k, off in _HARDENING_OFF.items()
                if knobs.get(k, off) != off)
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: the runner's hardening knobs come with ROADMAP "
            f"queue 1 item 15")


def _execute_plan(plan: Sequence[_Launch], cfgs, wlp: WorkloadParams,
                  grid_static, period_slots, trace_mode, decimate, device,
                  profile=None) -> Dict[object, list]:
    """Run every launch; returns scheme -> full row list (grid order)."""
    wlp = WorkloadParams(*(np.asarray(v) for v in wlp))
    rows: Dict[object, list] = {}
    for launch in plan:
        rows.setdefault(launch.scheme, []).extend(_run_launch(
            launch, cfgs, wlp, grid_static, period_slots, trace_mode,
            decimate, device, profile))
    return rows


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def run_experiment(cfg: NetConfig, workload: Workload, scheme,
                   horizon_us: Optional[float] = None, period_slots: int = 0,
                   delay_pad: int = 0, history_slots: int = 0, *,
                   trace_mode: str = "full", decimate: int = 1, channel=None,
                   device=None) -> Dict[str, float]:
    """The Fig. 3 metric set for one (config, workload, scheme): a B=1
    delegation onto the batch-wide extractors."""
    return run_experiment_batch(
        [cfg], workload, scheme, horizon_us, period_slots,
        trace_mode=trace_mode, decimate=decimate, delay_pad=delay_pad,
        history_slots=history_slots, channel=channel, device=device)[0]


def run_experiment_batch(cfgs: Sequence[NetConfig], workload, scheme,
                         horizon_us: Optional[float] = None,
                         period_slots: int = 0, *,
                         trace_mode: str = "full", decimate: int = 1,
                         chunk_cells: Optional[int] = None,
                         devices: Optional[Sequence] = None,
                         delay_pad: int = 0, history_slots: int = 0,
                         channel=None, device=None,
                         profile: Optional[list] = None,
                         **hardening) -> List[Dict[str, float]]:
    """Fig. 3 metrics for every scenario of a grid, from a chunked launch
    plan. ``workload``: shared ``Workload``, per-scenario sequence, or
    stacked ``WorkloadParams``. ``device``: ``cuda`` unless the caller says;
    ``profile``: a list that gets one timing dict per launch
    (``simulate_batch``'s ``profile``)."""
    cfgs = list(cfgs)
    _check_unported(cfgs, channel, trace_mode, decimate, devices, hardening)
    dev = resolve_device(device)
    scheme = get_scheme(scheme)
    wlp = as_workload_batch(workload, len(cfgs))
    grid_static = _grid_static(cfgs, horizon_us, delay_pad, history_slots)
    chunk = _auto_chunk_cells(grid_static[1], trace_mode, decimate,
                              chunk_cells, dev, cfgs[0].num_paths)
    plan = _plan_launches(len(cfgs), (scheme,), chunk)
    return _execute_plan(plan, cfgs, wlp, grid_static, period_slots,
                         trace_mode, decimate, dev, profile)[scheme]


def convergence_horizon_us(cfgs: Sequence[NetConfig],
                           floor_us: float = 20_000.0) -> float:
    """Horizon long enough for CC to converge at EVERY distance of a grid:
    at least 20 RTTs at the farthest scenario plus a fixed floor."""
    return 40.0 * max(c.one_way_delay_us for c in cfgs) + floor_us


def sweep(cfg: NetConfig, workload: Workload, schemes, distances_km,
          horizon_us: Optional[float] = None, period_slots: int = 0, **kw):
    """Cartesian (distance x scheme) sweep; rows in the order
    ``for d in distances: for s in schemes``. All cells share one horizon,
    the longest any distance needs to converge."""
    cfgs = [dataclasses.replace(cfg, distance_km=float(d))
            for d in distances_km]
    h = horizon_us
    if h is None:
        h = max(cfg.horizon_us, convergence_horizon_us(cfgs))
    return sweep_grid(cfgs, workload, schemes, h, period_slots, **kw)


def sweep_grid(scenarios, workload=None, schemes=(),
               horizon_us: Optional[float] = None, period_slots: int = 0, *,
               trace_mode: str = "full", decimate: int = 1,
               chunk_cells: Optional[int] = None,
               devices: Optional[Sequence] = None, channel=None,
               device=None, **hardening):
    """Heterogeneous scenario grids x schemes as ONE launch plan; rows in
    the order ``for scenario: for scheme``. Either
    ``sweep_grid([Scenario(cfg, wl), ...], schemes)`` (each cell its own
    config and workload) or ``sweep_grid(cfgs, shared_workload, schemes)``."""
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("sweep_grid: empty scenario grid")
    if isinstance(scenarios[0], Scenario):
        if workload is not None and not schemes \
                and not isinstance(workload, (Workload, WorkloadParams)):
            workload, schemes = None, workload     # sweep_grid(scenarios, schemes)
        if workload is not None:
            raise ValueError(
                "sweep_grid: Scenario cells carry their own workloads - "
                "drop the workload argument")
        cfgs = [s.net for s in scenarios]
        wl = [s.workload for s in scenarios]
    else:
        cfgs, wl = scenarios, workload
        if wl is None:
            raise ValueError(
                "sweep_grid: pass a workload (or a grid of Scenario cells)")
    if isinstance(schemes, str):
        schemes = (schemes,)
    if not schemes:
        raise ValueError(
            "sweep_grid: no schemes given - pass schemes=(\"dcqcn\", ...)")
    _check_unported(cfgs, channel, trace_mode, decimate, devices, hardening)
    dev = resolve_device(device)
    scheme_objs = [get_scheme(s) for s in schemes]
    wlp = as_workload_batch(wl, len(cfgs))
    grid_static = _grid_static(cfgs, horizon_us, 0, 0)
    chunk = _auto_chunk_cells(grid_static[1], trace_mode, decimate,
                              chunk_cells, dev, cfgs[0].num_paths)
    plan = _plan_launches(len(cfgs), scheme_objs, chunk)
    by_scheme = _execute_plan(plan, cfgs, wlp, grid_static, period_slots,
                              trace_mode, decimate, dev)
    return [by_scheme[s][i] for i in range(len(cfgs)) for s in scheme_objs]
