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
  * ``window``   ``metrics`` plus the last-W-steps ring and the event ring
                 (``WindowAux``); its rows come from ``WindowAux.acc``, equal
                 to ``metrics``'s bit for bit.

Multi-link and multi-site grids (``num_paths > 1``, site graphs) run like
any other; rdmacell adds its spraying columns there. A non-ideal channel or
a failure schedule adds the channel columns (``goodput_gbps``,
``wire_gbps``, ``retx_frac``, ``p99_repair_latency_us``) in every mode, and
a failure schedule the failover columns (``failover_collapse_frac``,
``failover_recovery_us``) from materialized traces.

Hardening (opt-in, as in the JAX runner): ``strict_conservation`` raises
``ConservationError`` at the (scheme, cell, step) of the first violation,
``on_nonfinite`` keeps, quarantines or raises on diverged cells,
``checkpoint_dir`` writes one atomic JSON checkpoint per finished launch
(``resume`` reloads them under a sha256 fingerprint of the plan),
``abort_after_launches`` is the crash-injection hook, and a launch that
runs out of device memory is split in two, down to single cells.
``manifest_path`` writes a JSONL run manifest in the JAX package's schema
(``netsim.obs.profile``): a header with the plan's fingerprint and one record
per launch, its graph-capture and replay times and device memory figures,
which ``tools/obs_report.py`` summarizes and diffs. ``devices=`` (sharding a
grid over several devices) comes with ROADMAP queue 1 item 17 and raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.net import NetConfig, batch_template
from repro_torch.device import resolve_device
from repro_torch.netsim.channel import get_channel_model
from repro_torch.netsim.fluid import (
    STREAM_MAX_KEYS, STREAM_SUM_KEYS, WARMUP_FRAC, batch_padding,
    check_main_path, is_unfinished, simulate_batch,
)
from repro_torch.netsim.obs.profile import profiled_traced_batch, write_manifest
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


def _channel_cols_from_traces(traces_np: dict, warm: int, dt_s: float,
                              decimate: int = 1) -> dict:
    """The channel columns from materialized ``chan_*`` traces, the
    full/decimate twin of ``ChannelModel.finalize_metrics``. Rates are over
    simulated time: a decimated sample is the SUM of its block's bytes
    (``fluid.DECIMATE_SUM_KEYS``), so the columns agree at any decimation."""
    wire = traces_np["chan_wire"][:, warm:].astype(np.float64)
    lost = traces_np["chan_lost"][:, warm:].astype(np.float64)
    retx = traces_np["chan_retx"][:, warm:].astype(np.float64)
    wait = traces_np["chan_repair_wait_us"][:, warm:]
    per_s = 1.0 / (max(wire.shape[1], 1) * max(decimate, 1) * dt_s)
    # p99 over the steps with a repair pending (as the streamed histogram)
    p99 = np.zeros(wire.shape[0])
    for i in range(wire.shape[0]):
        pending = wait[i][wait[i] > 0]
        p99[i] = np.percentile(pending, 99) if pending.size else 0.0
    return {
        "goodput_gbps": (wire.sum(axis=1) - lost.sum(axis=1))
        * per_s * 8.0 / 1e9,
        "wire_gbps": wire.sum(axis=1) * per_s * 8.0 / 1e9,
        "retx_frac": retx.sum(axis=1) / np.maximum(wire.sum(axis=1), 1.0),
        "p99_repair_latency_us": p99,
    }


def _failover_cols_from_traces(cfgs: Sequence[NetConfig], traces_np: dict,
                               decimate: int = 1) -> dict:
    """Failover scores from the ``thr_inter`` series of cells with a failure
    schedule: ``failover_collapse_frac`` = 1 - (mean inter-DC throughput over
    the outage span) / (mean before the first down edge), clipped to [0, 1];
    ``failover_recovery_us`` = time from the last up edge until the
    throughput first regains 90 % of the pre-outage mean (clamped to the end
    of the trace). The span is [min down, max up] over a cell's real windows;
    a cell without one (an all-up control) scores 0 on both. Sample j of a
    decimated trace is the value at step ``(j+1)*decimate - 1``."""
    thr = np.asarray(traces_np["thr_inter"], np.float64)       # [B, S]
    n_cells, n_samples = thr.shape
    t_us = (np.arange(n_samples, dtype=np.float64) + 1.0) \
        * max(decimate, 1) * cfgs[0].dt_us
    collapse = np.zeros(n_cells)
    recovery = np.zeros(n_cells)
    for i, cfg in enumerate(cfgs[:n_cells]):
        fa = np.asarray(cfg.failure_array(), np.float64)       # [L, W, 2]
        real = fa[..., 1] > fa[..., 0]
        if not real.any():
            continue
        down = fa[..., 0][real].min()
        up = fa[..., 1][real].max()
        pre = thr[i][t_us < down]
        base = pre.mean() if pre.size else 0.0
        if base <= 0.0:
            continue
        span = thr[i][(t_us >= down) & (t_us < up)]
        during = span.mean() if span.size else 0.0
        collapse[i] = min(max(1.0 - during / base, 0.0), 1.0)
        post = t_us >= up
        rec = post & (thr[i] >= 0.9 * base)
        if rec.any():
            recovery[i] = t_us[rec].min() - up
        elif post.any():
            recovery[i] = max(t_us[-1] - up, 0.0)
    return {"failover_collapse_frac": collapse,
            "failover_recovery_us": recovery}


def _metrics_batch(cfgs: Sequence[NetConfig], wl: WorkloadParams,
                   scheme_name: str, final_np: dict, traces_np: dict,
                   decimate: int = 1) -> List[Dict[str, float]]:
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
    if "chan_wire" in traces_np:
        cols.update(_channel_cols_from_traces(
            traces_np, warm, cfgs[0].dt_us * 1e-6, decimate))
    if cfgs[0].failure_len > 0:
        cols.update(_failover_cols_from_traces(cfgs, traces_np, decimate))
    return _assemble_rows(cfgs, scheme_name, cols)


def _numpy_tree(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return {k: _numpy_tree(v) for k, v in tree.items()}


def _metrics_streaming(cfgs: Sequence[NetConfig], wl: WorkloadParams, scheme,
                       channel, final_np: dict, acc, steps: int,
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
    extra = dict(scheme.finalize_metrics(_numpy_tree(acc.scheme), steps,
                                         n_warm) or {})
    # the channel accumulator streams under the ideal channel too when a
    # failure schedule is armed (outage losses ride the chan_* keys)
    if acc.chan is not None:
        extra.update(channel.finalize_metrics(
            _numpy_tree(acc.chan), steps, n_warm, cfgs[0].dt_us * 1e-6))
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
                num_links: int = 1, schedule_floats: int = 0) -> int:
    """Scenario cells per launch: the explicit ``chunk_cells`` override, or
    the bounded-memory auto size (full/decimate: the materialized trace
    block stays under the trace-float budget of ``device``, counting the
    three ``[L]`` trace keys of a multi-link grid; metrics: the flat
    ``METRICS_CHUNK_CELLS`` ceiling, window mode's O(B W) ring included).
    ``schedule_floats`` is a cell's
    resident schedule tables (``_sched_floats``), counted in every mode."""
    if chunk_cells is None:
        if trace_mode in ("metrics", "window"):
            chunk_cells = METRICS_CHUNK_CELLS
            if schedule_floats > 0:
                chunk_cells = min(chunk_cells,
                                  max(MAX_TRACE_FLOATS // schedule_floats, 1))
        else:
            t = max(steps // max(decimate, 1), 1)
            # q_dst_link / link_tx / link_pause are [L] per step at L > 1
            keys = _TRACE_KEYS_EST + (3 * num_links if num_links > 1 else 0)
            budget = _trace_float_budget(device or torch.device("cpu"))
            chunk_cells = max(
                budget // (t * keys + max(schedule_floats, 0)), 1)
    return max(int(chunk_cells), 1)


def _sched_floats(cfg: NetConfig) -> int:
    """f32 values of a cell's resident schedule tables: the trace-replay
    channel schedule ([L, K, 3]) and the failure windows ([L, W, 2])."""
    return (cfg.num_paths * cfg.schedule_len * 3
            + cfg.num_paths * cfg.failure_len * 2)


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


# ---------------------------------------------------------------------------
# Runner hardening: conservation guard, finite guard, checkpoint/resume, OOM
# backoff
# ---------------------------------------------------------------------------


class ConservationError(RuntimeError):
    """``strict_conservation``: a cell's conservation residual (``cons_err``,
    max over flows of |residual| / max(sent, 1)) went over the tolerance.
    Carries the grid-order ``cell`` and the engine ``step`` of the first
    violation (None under ``trace_mode="metrics"``, which streams only the
    running max)."""

    def __init__(self, scheme_name: str, cell: int, step: Optional[int],
                 err: float, tol: float):
        self.scheme_name, self.cell, self.step = scheme_name, cell, step
        self.err, self.tol = err, tol
        where = (f"step {step}" if step is not None
                 else "step unknown (trace_mode='metrics' streams only the "
                      "running max - rerun with trace_mode='full' to "
                      "localize)")
        super().__init__(
            f"strict_conservation: scheme {scheme_name!r} violated byte "
            f"conservation at cell {cell}, {where}: "
            f"|residual|/sent = {err:.3e} > tol {tol:.1e}")


def _check_conservation(scheme_name: str, aux, lo: int, n_real: int,
                        trace_mode: str, decimate: int, tol: float) -> None:
    """The first ``cons_err > tol`` -> ``ConservationError`` at grid-order
    (cell, step); sample j of a decimated trace is step ``(j+1)*decimate -
    1``; metrics mode reports no step."""
    if trace_mode in ("metrics", "window"):
        maxes = aux.maxes if trace_mode == "metrics" else aux.acc.maxes
        m = maxes[..., STREAM_MAX_KEYS.index("cons_err")].cpu().numpy()[:n_real]
        bad = m > tol
        if bad.any():
            i = int(np.argmax(bad))
            raise ConservationError(scheme_name, lo + i, None, float(m[i]), tol)
        return
    k = decimate if trace_mode == "decimate" else 1
    cons = aux["cons_err"]
    cons = (cons.cpu().numpy() if torch.is_tensor(cons) else np.asarray(cons))[:n_real]
    bad = cons > tol
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise ConservationError(scheme_name, lo + int(i), (int(j) + 1) * k - 1,
                                float(cons[i, j]), tol)


# ``avg_fct_us`` is exempt from the finite guard: inf (no flow finished) and
# nan (no finite flow) are its in-band sentinels
_NONFINITE_EXEMPT = ("avg_fct_us",)


def _guard_nonfinite(rows: List[dict], lo: int, on_nonfinite: str) -> List[dict]:
    """Per-cell finite guard: ``"keep"`` passes rows through, ``"quarantine"``
    swaps a diverged cell's row for a failure record (``failed=True``, the
    offending columns, the grid-order cell), ``"raise"`` aborts naming
    them."""
    if on_nonfinite == "keep":
        return rows
    out = []
    for i, row in enumerate(rows):
        bad = sorted(k for k, v in row.items()
                     if k not in _NONFINITE_EXEMPT
                     and isinstance(v, float) and not np.isfinite(v))
        if not bad:
            out.append(row)
            continue
        cell = lo + i
        if on_nonfinite == "raise":
            raise RuntimeError(
                f"non-finite metrics at cell {cell} "
                f"(scheme {row.get('scheme')!r}): columns {bad} - rerun "
                f"with on_nonfinite='quarantine' to skip diverged cells")
        out.append({"scheme": row.get("scheme"),
                    "distance_km": row.get("distance_km", float("nan")),
                    "cell_index": cell, "failed": True,
                    "nonfinite_cols": bad})
    return out


def _plan_fingerprint(plan, cfgs, wlp_np, grid_static, period_slots,
                      trace_mode, decimate, channel) -> str:
    """sha256 of everything that decides a plan's rows (configs, workload
    leaves, grid statics, modes, channel, scheme set): a resume against
    checkpoints of another plan refuses."""
    h = hashlib.sha256()
    for c in cfgs:
        h.update(repr(c).encode())
    for leaf in wlp_np:
        a = np.asarray(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    names = tuple(sorted({launch.scheme.name for launch in plan}))
    h.update(repr((tuple(grid_static), int(period_slots), trace_mode,
                   int(decimate), getattr(channel, "name", None),
                   names)).encode())
    return h.hexdigest()


def _checkpoint_path(checkpoint_dir: str, launch: _Launch) -> str:
    return os.path.join(checkpoint_dir,
                        f"{launch.scheme.name}_{launch.lo}_{launch.hi}.json")


def _load_checkpoint(path: str, fingerprint: str) -> Optional[list]:
    """A finished launch's rows, or None to (re)run it: a torn file (killed
    before the atomic rename) counts as absent; a valid file of another
    plan raises."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (json.JSONDecodeError, OSError, UnicodeDecodeError):
        return None
    if data.get("fingerprint") != fingerprint:
        raise ValueError(
            f"--resume: checkpoint {path} was written by a DIFFERENT "
            f"launch plan (grid, workload, horizon, trace mode, channel "
            f"or scheme set changed); delete the checkpoint directory to "
            f"start this sweep from scratch")
    return data["rows"]


def _write_checkpoint(path: str, fingerprint: str, launch: _Launch,
                      rows: list) -> None:
    """Atomic per-launch checkpoint: JSON floats round-trip exactly, and the
    temporary file plus rename leaves the whole file or none."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"fingerprint": fingerprint, "scheme": launch.scheme.name,
                   "lo": launch.lo, "hi": launch.hi, "rows": rows}, f)
    os.replace(tmp, path)


def _is_oom_error(e: Exception) -> bool:
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = str(e)
    return "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()


def _run_launch(launch: _Launch, cfgs, wlp: WorkloadParams, grid_static,
                period_slots, trace_mode, decimate, device, channel,
                strict_conservation: bool = False,
                conservation_tol: float = 1e-3,
                profile: Optional[list] = None,
                record: Optional[dict] = None) -> List[dict]:
    """One launch -> its real cells' rows (grid order); its timings are
    appended to ``profile`` when given, and ``record`` (a run manifest's
    launch record) is filled by ``obs.profiled_traced_batch``. A launch
    that runs out of device memory is retried as two half-size launches,
    down to single cells. The conservation guard runs per launch, so the
    error names the first violation of the first offending chunk."""
    horizon, steps, warm, delay_pad, history_slots = grid_static
    sub_cfgs = cfgs[launch.lo:launch.hi]
    sub_wlp = WorkloadParams(*(v[launch.lo:launch.hi] for v in wlp))
    n_real = len(sub_cfgs)
    sub_cfgs, sub_wlp = _pad_chunk(sub_cfgs, sub_wlp, launch.pad_to)
    timing = ({"scheme": launch.scheme.name, "real_cells": n_real}
              if profile is not None else None)
    kw = dict(trace_mode=trace_mode, decimate=decimate, delay_pad=delay_pad,
              history_slots=history_slots, warm_steps=warm, channel=channel,
              device=device)
    try:
        if record is not None:
            final, aux = profiled_traced_batch(
                sub_cfgs, sub_wlp, launch.scheme, horizon, period_slots,
                record, timing=timing, **kw)
        else:
            final, aux = simulate_batch(
                sub_cfgs, sub_wlp, launch.scheme, horizon, period_slots,
                profile=timing, **kw)
    except Exception as e:  # noqa: BLE001 - filtered to device OOM here
        if not _is_oom_error(e) or n_real <= 1:
            raise
        if device.type == "cuda":
            torch.cuda.empty_cache()
        mid = launch.lo + (n_real + 1) // 2
        warnings.warn(
            f"launch ({launch.scheme.name}, cells [{launch.lo}, "
            f"{launch.hi})) hit device OOM; retrying as two half-size "
            f"launches", RuntimeWarning, stacklevel=2)
        if record is not None:
            record["oom_split"] = True
        rows = []
        for lo, hi in ((launch.lo, mid), (mid, launch.hi)):
            rows.extend(_run_launch(
                _Launch(launch.scheme, lo, hi, hi - lo), cfgs, wlp,
                grid_static, period_slots, trace_mode, decimate, device,
                channel, strict_conservation, conservation_tol, profile))
        return rows
    if profile is not None:
        profile.append(timing)
    if strict_conservation:
        _check_conservation(launch.scheme.name, aux, launch.lo, n_real,
                            trace_mode, decimate, conservation_tol)
    final_np = {"delivered": final.delivered.cpu().numpy(),
                "done_at_us": final.done_at_us.cpu().numpy()}
    if trace_mode in ("metrics", "window"):
        acc = aux if trace_mode == "metrics" else aux.acc
        rows = _metrics_streaming(sub_cfgs, sub_wlp, launch.scheme, channel,
                                  final_np, acc, steps, warm)
    else:
        traces_np = {k: v.cpu().numpy() for k, v in aux.items()}
        rows = _metrics_batch(sub_cfgs, sub_wlp, launch.scheme.name, final_np,
                              traces_np, decimate if trace_mode == "decimate" else 1)
    return rows[:n_real]


def _check_unported(channel, trace_mode, decimate, devices,
                    on_nonfinite) -> None:
    check_main_path(channel, trace_mode, decimate)
    if devices is not None:
        raise NotImplementedError(
            "devices=: sharding a grid over several devices comes with ROADMAP "
            "queue 1 item 17; pass device= for the one device to run on")
    if on_nonfinite not in ("keep", "quarantine", "raise"):
        raise ValueError(
            f"on_nonfinite must be 'keep', 'quarantine' or 'raise', "
            f"got {on_nonfinite!r}")


def _execute_plan(plan: Sequence[_Launch], cfgs, wlp: WorkloadParams,
                  grid_static, period_slots, trace_mode, decimate, device,
                  channel=None, profile=None, *,
                  checkpoint_dir: Optional[str] = None, resume: bool = False,
                  on_nonfinite: str = "keep",
                  strict_conservation: bool = False,
                  conservation_tol: float = 1e-3,
                  abort_after_launches: Optional[int] = None,
                  manifest_path: Optional[str] = None
                  ) -> Dict[object, list]:
    """Run every launch; returns scheme -> full row list (grid order).

    ``checkpoint_dir``: one atomic JSON checkpoint per finished launch; with
    ``resume`` a rerun of the SAME plan loads finished launches (bit-equal
    rows) and runs the rest, and a checkpoint of another plan raises.
    ``on_nonfinite``: ``"keep"`` / ``"quarantine"`` / ``"raise"``.
    ``strict_conservation``: ``ConservationError`` on the first ``cons_err
    > conservation_tol``. ``abort_after_launches``: raise after that many
    executed launches (their checkpoints already written), the
    crash-injection hook of the resume tests. ``manifest_path``: write a
    JSONL run manifest (a header with the git rev, the plan's fingerprint
    and the backend, one record per launch with its capture / replay times
    and device memory figures; a launch loaded from its checkpoint is
    recorded as ``resumed``)."""
    channel = get_channel_model(channel)
    wlp = WorkloadParams(*(np.asarray(v) for v in wlp))
    fingerprint = None
    if checkpoint_dir is not None or manifest_path is not None:
        fingerprint = _plan_fingerprint(plan, cfgs, wlp, grid_static,
                                        period_slots, trace_mode, decimate,
                                        channel)
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
    manifest = [] if manifest_path is not None else None
    rows: Dict[object, list] = {}
    executed = 0
    for launch in plan:
        ckpt = (_checkpoint_path(checkpoint_dir, launch)
                if checkpoint_dir is not None else None)
        if ckpt is not None and resume:
            cached = _load_checkpoint(ckpt, fingerprint)
            if cached is not None:
                rows.setdefault(launch.scheme, []).extend(cached)
                if manifest is not None:
                    manifest.append({"scheme": launch.scheme.name,
                                     "lo": launch.lo, "hi": launch.hi,
                                     "pad_to": launch.pad_to,
                                     "resumed": True})
                continue
        if abort_after_launches is not None and executed >= abort_after_launches:
            raise RuntimeError(
                f"abort_after_launches: aborting sweep after {executed} "
                f"executed launches (crash-injection hook)")
        rec = {} if manifest is not None else None
        sub_rows = _guard_nonfinite(
            _run_launch(launch, cfgs, wlp, grid_static, period_slots,
                        trace_mode, decimate, device, channel,
                        strict_conservation, conservation_tol, profile, rec),
            launch.lo, on_nonfinite)
        if ckpt is not None:
            _write_checkpoint(ckpt, fingerprint, launch, sub_rows)
        executed += 1
        if manifest is not None:
            rec.update(scheme=launch.scheme.name, lo=launch.lo, hi=launch.hi,
                       pad_to=launch.pad_to, n_real=launch.hi - launch.lo)
            manifest.append(rec)
        rows.setdefault(launch.scheme, []).extend(sub_rows)
    if manifest_path is not None:
        executed_recs = [m for m in manifest if not m.get("resumed")]
        header = {
            "fingerprint": fingerprint,
            "backend": device.type,
            "n_devices": 1,
            "trace_mode": trace_mode,
            "decimate": int(decimate),
            "horizon_us": float(grid_static[0]),
            "steps": int(grid_static[1]),
            "warm_steps": int(grid_static[2]),
            "n_cells": len(cfgs),
            "schemes": sorted({ln.scheme.name for ln in plan}),
            "n_launches": len(plan),
            "n_resumed": len(manifest) - len(executed_recs),
            "total_compile_s": sum(m.get("compile_s", 0.0)
                                   for m in executed_recs),
            "total_execute_s": sum(m.get("execute_s", 0.0)
                                   for m in executed_recs),
        }
        write_manifest(manifest_path, header, manifest)
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
                         checkpoint_dir: Optional[str] = None,
                         resume: bool = False, on_nonfinite: str = "keep",
                         strict_conservation: bool = False,
                         conservation_tol: float = 1e-3,
                         abort_after_launches: Optional[int] = None,
                         manifest_path: Optional[str] = None
                         ) -> List[Dict[str, float]]:
    """Fig. 3 metrics for every scenario of a grid, from a chunked launch
    plan. ``workload``: shared ``Workload``, per-scenario sequence, or
    stacked ``WorkloadParams``. ``channel``: the channel model of every cell
    (name or model, None = ideal). ``device``: ``cuda`` unless the caller
    says; ``profile``: a list that gets one timing dict per launch
    (``simulate_batch``'s ``profile``). The hardening knobs are
    ``_execute_plan``'s."""
    cfgs = list(cfgs)
    _check_unported(channel, trace_mode, decimate, devices,
                    on_nonfinite)
    dev = resolve_device(device)
    scheme = get_scheme(scheme)
    wlp = as_workload_batch(workload, len(cfgs))
    grid_static = _grid_static(cfgs, horizon_us, delay_pad, history_slots)
    chunk = _auto_chunk_cells(grid_static[1], trace_mode, decimate,
                              chunk_cells, dev, cfgs[0].num_paths,
                              _sched_floats(cfgs[0]))
    plan = _plan_launches(len(cfgs), (scheme,), chunk)
    return _execute_plan(
        plan, cfgs, wlp, grid_static, period_slots, trace_mode, decimate, dev,
        channel, profile, checkpoint_dir=checkpoint_dir, resume=resume,
        on_nonfinite=on_nonfinite, strict_conservation=strict_conservation,
        conservation_tol=conservation_tol,
        abort_after_launches=abort_after_launches,
        manifest_path=manifest_path)[scheme]


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
               device=None, profile: Optional[list] = None,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               on_nonfinite: str = "keep", strict_conservation: bool = False,
               conservation_tol: float = 1e-3,
               abort_after_launches: Optional[int] = None,
               manifest_path: Optional[str] = None):
    """Heterogeneous scenario grids x schemes as ONE launch plan; rows in
    the order ``for scenario: for scheme``. Either
    ``sweep_grid([Scenario(cfg, wl), ...], schemes)`` (each cell its own
    config and workload) or ``sweep_grid(cfgs, shared_workload, schemes)``.
    ``channel`` and the hardening knobs as in ``run_experiment_batch``."""
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
    _check_unported(channel, trace_mode, decimate, devices,
                    on_nonfinite)
    dev = resolve_device(device)
    scheme_objs = [get_scheme(s) for s in schemes]
    wlp = as_workload_batch(wl, len(cfgs))
    grid_static = _grid_static(cfgs, horizon_us, 0, 0)
    chunk = _auto_chunk_cells(grid_static[1], trace_mode, decimate,
                              chunk_cells, dev, cfgs[0].num_paths,
                              _sched_floats(cfgs[0]))
    plan = _plan_launches(len(cfgs), scheme_objs, chunk)
    by_scheme = _execute_plan(
        plan, cfgs, wlp, grid_static, period_slots, trace_mode, decimate, dev,
        channel, profile, checkpoint_dir=checkpoint_dir, resume=resume,
        on_nonfinite=on_nonfinite, strict_conservation=strict_conservation,
        conservation_tol=conservation_tol,
        abort_after_launches=abort_after_launches,
        manifest_path=manifest_path)
    return [by_scheme[s][i] for i in range(len(cfgs)) for s in scheme_objs]
