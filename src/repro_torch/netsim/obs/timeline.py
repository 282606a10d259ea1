"""Timeline export: window-mode trace rings + event rings -> Chrome
trace-event JSON loadable in Perfetto UI / ``chrome://tracing``.

The torch twin of the JAX package's ``netsim/obs/timeline.py``: numpy and
JSON over the rings (torch tensors are read back to the host first). Given
the same arrays it writes the same document as the JAX package, the
``producer`` tag included: the document's schema is shared by both.

The Chrome trace-event format (``{"traceEvents": [...]}``) is the lowest
common denominator both viewers accept. We map the netsim structure onto
it as:

  * one **process** (``pid``) per sweep cell, named after its label
  * **counter tracks** (``"ph": "C"``) for every windowed trace key — one
    counter per scalar key, one per link/flow lane of a vector key — so
    queue depths, pause states and throughputs render as stacked area
    charts over simulated time
  * **instant events** (``"ph": "i"``) for every decoded ring event, on a
    per-kind track, carrying ``obj``/``value`` in ``args``

Timestamps are the engine's simulated microseconds verbatim (the trace
format's native unit), so the viewer's ruler reads sim time directly.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .events import _np, decode_events, unroll_window


def _counter_events(pid: int, key: str, step_idx, values, dt_us: float):
    """One windowed trace key -> counter events (one lane per trailing
    index for vector keys)."""
    vals = np.asarray(values, np.float64)
    lanes = [("", vals)] if vals.ndim == 1 else [
        (f"[{i}]", vals[..., i]) for i in range(vals.shape[-1])]
    # collapse >2-D keys ([W, L, F] etc.) to per-leading-lane sums: the
    # viewer wants a handful of lanes, not a lane per flow
    if vals.ndim > 2:
        vals2 = vals.reshape(vals.shape[0], vals.shape[1], -1).sum(axis=-1)
        lanes = [(f"[{i}]", vals2[..., i]) for i in range(vals2.shape[-1])]
    out = []
    for suffix, series in lanes:
        name = key + suffix
        for t, v in zip(step_idx, series):
            out.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                        "ts": float(t) * float(dt_us),
                        "args": {name: float(v)}})
    return out


def timeline_cell(pid: int, *, label: str, dt_us: float, steps: int,
                  window_steps: int, window: Optional[dict] = None,
                  events: Optional[list] = None) -> list:
    """Trace events of ONE cell: a process-name metadata record, counter
    tracks for ``window`` (already cell-indexed, leaves [W, ...]), and
    instant events for ``events`` (decoded dicts from
    ``decode_events``)."""
    recs = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": label}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "traces"}}]
    if window:
        step_idx, ordered = unroll_window(window, steps, window_steps)
        for key in sorted(ordered):
            recs.extend(_counter_events(pid, key, step_idx, ordered[key],
                                        dt_us))
    if events:
        recs.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 1, "args": {"name": "events"}})
        for ev in events:
            recs.append({"name": ev["kind"], "ph": "i", "s": "t",
                         "pid": pid, "tid": 1, "ts": float(ev["t_us"]),
                         "args": {"obj": ev["obj"], "value": ev["value"]}})
    return recs


def timeline_from_window(aux, *, dt_us: float, steps: int,
                         window_steps: int, event_ring_slots: int = 0,
                         labels: Optional[list] = None) -> dict:
    """A ``WindowAux`` (from ``simulate``/``simulate_batch`` under
    ``trace_mode="window"``) -> Chrome trace-event document. Handles both
    the unbatched aux (leaves [W, ...]) and the batched one (leaves
    [B, W, ...]); ``labels`` names the per-cell processes."""
    # unbatched window leaves are [W, ...]; batched are [B, W, ...]. The
    # engine always emits the scalar ``cons_err`` trace, which makes the
    # distinction unambiguous ([W] vs [B, W]).
    probe_key = "cons_err" if "cons_err" in aux.window else min(
        aux.window, key=lambda k: _np(aux.window[k]).ndim)
    probe = _np(aux.window[probe_key])
    batched = probe.ndim == 2
    n_cells = int(probe.shape[0]) if batched else 1
    recs = []
    for b in range(n_cells):
        label = labels[b] if labels else f"cell {b}"
        win = {k: _np(v)[b] if batched else _np(v)
               for k, v in aux.window.items()}
        evs = None
        if aux.events is not None and event_ring_slots > 0:
            evs = decode_events(aux.events, event_ring_slots,
                                cell=b if batched else None)
        recs.extend(timeline_cell(b, label=label, dt_us=dt_us, steps=steps,
                                  window_steps=window_steps, window=win,
                                  events=evs))
    return {"traceEvents": recs, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro.netsim.obs",
                          "steps": int(steps), "dt_us": float(dt_us)}}


def timeline_from_traces(traces: dict, *, dt_us: float, decimate: int = 1,
                         labels: Optional[list] = None,
                         cell: Optional[int] = None) -> dict:
    """Full/decimate-mode trace dict -> Chrome trace-event document.
    Leaves are [T, ...] (sequential run) or [B, T, ...] (batch); pass
    ``cell`` to export a single batch cell. Decimated traces are spaced
    ``decimate`` steps apart on the time axis."""
    traces = {k: _np(v) for k, v in traces.items()}
    first = next(iter(traces.values()))
    batched = first.ndim >= 2 and cell is None and _looks_batched(traces)
    cells = range(first.shape[0]) if batched else [cell or 0]
    recs = []
    for pid, b in enumerate(cells):
        label = labels[pid] if labels else f"cell {b}"
        recs.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": label}})
        for key in sorted(traces):
            arr = np.asarray(traces[key])
            series = arr[b] if (batched or cell is not None) else arr
            t_idx = np.arange(series.shape[0]) * decimate
            recs.extend(_counter_events(pid, key, t_idx, series, dt_us))
    return {"traceEvents": recs, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro.netsim.obs",
                          "decimate": int(decimate), "dt_us": float(dt_us)}}


def _looks_batched(traces: dict) -> bool:
    # batched trace dicts have every leaf sharing the same 2 leading dims
    shapes = {np.asarray(v).shape[:2] for v in traces.values()}
    return len(shapes) == 1 and all(np.asarray(v).ndim >= 2
                                    for v in traces.values())


def export_timeline(path: str, doc_or_aux, **kwargs) -> str:
    """Write a timeline document (or build one from a ``WindowAux`` via
    ``timeline_from_window(**kwargs)``) as Chrome trace-event JSON.
    Returns ``path``."""
    if isinstance(doc_or_aux, dict) and "traceEvents" in doc_or_aux:
        doc = doc_or_aux
    else:
        doc = timeline_from_window(doc_or_aux, **kwargs)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path
