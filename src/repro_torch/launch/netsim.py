"""The paper's Fig. 3 figures through the port's netsim, on the card.

    PYTHONPATH=src python -m repro_torch.launch.netsim --figure fig3b \
        [--full] [--device cpu] [--horizon-us US] [--profile-steps N]

The torch twin of ``benchmarks/figures.py`` ``fig3b_throughput``,
``fig3cd_buffer_pause`` and ``fig3e_fct``: the same grids (reduced unless
``--full``), horizons and derived rows (max speedup vs DCQCN, buffer and
pause reduction, FCT improvement), printed as ``name,value,note`` with
``value`` the wall time per cell in us, as ``figures.py`` prints them. Each
scheme's whole grid runs as one ``[B]`` batch (``figures.py`` runs fig3b per
message size; the cells are independent, so the rows are the same).

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
import json
import time
from typing import List, Optional

import torch

from repro_torch.config.net import NetConfig
from repro_torch.device import resolve_device
from repro_torch.netsim import (
    SCHEMES, congestion_workload, mixed_fct_workload, run_experiment_batch,
    throughput_workload,
)
from repro_torch.netsim.fluid import build_batch

PROFILE_STEPS = 100


class Figure:
    """Runs one figure's batches and keeps each scheme's timing record."""

    def __init__(self, name: str, device: torch.device,
                 horizon_us: Optional[float] = None,
                 profile_steps: int = PROFILE_STEPS):
        self.name, self.device = name, device
        self.horizon_us = horizon_us
        self.profile_steps = profile_steps
        self.records: List[dict] = []

    def horizon(self, paper_us: float) -> float:
        return paper_us if self.horizon_us is None else self.horizon_us

    def run(self, cfgs, workload, scheme: str, horizon_us: float):
        """The rows of one scheme's batch and its wall us per cell."""
        launches: list = []
        t0 = time.perf_counter()
        rows = run_experiment_batch(cfgs, workload, scheme, horizon_us,
                                    device=self.device, profile=launches)
        wall_s = time.perf_counter() - t0
        steps = launches[0]["steps"]
        run_ms = sum(p["run_ms"] for p in launches)
        rec = {"figure": self.name, "scheme": scheme, "cells": len(cfgs),
               "steps": steps, "launches": len(launches), "wall_s": wall_s,
               "capture_s": sum(p["capture_s"] for p in launches),
               "cell_steps_per_s": len(cfgs) * steps / wall_s}
        # CUDA events on the card, the host clock on the CPU
        rec["device_ms_per_step" if self.device.type == "cuda" else
            "cpu_ms_per_step"] = run_ms / max(steps * len(launches), 1)
        if self.device.type == "cuda" and self.profile_steps > 0:
            rec.update(step_profile(cfgs, workload, scheme, self.device,
                                    self.profile_steps))
        self.records.append(rec)
        return rows, wall_s * 1e6 / len(cfgs)


def step_profile(cfgs, workload, scheme: str, device: torch.device,
                 n_steps: int = PROFILE_STEPS,
                 graph_kernels: int = 4096) -> dict:
    """Where a step's time goes on the card: ``n_steps`` eager steps of the
    batch under ``torch.profiler`` (kernels launched and kernel ms per step,
    time by kernel), then one replay of a CUDA graph of about
    ``graph_kernels`` kernels (at most 20 steps) under it: the device's idle
    share over the replay, 1 - the kernels' summed time / the span from the
    first kernel's start to the last one's end. Only device activity is
    recorded; a replay of 8,600 kernels (20 matchrdma steps) ran twice as
    long under the profiler as without it, so the replay is kept short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, state, step = build_batch(cfgs, workload, scheme, device=device)
    t = torch.zeros((), dtype=torch.int32, device=device)

    def run(state, t, n):
        for _ in range(n):
            state, _ = step(state, t)
            t = t + 1
        return state, t

    state, t = run(state, t, 3)                   # warm-up
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, t = run(state, t, n_steps)
        torch.cuda.synchronize(device)
    eager = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return {"profiled_steps": n_steps,
            "kernels_per_step": len(eager) / n_steps,
            "kernel_ms_per_step": sum(e.time_range.elapsed_us() for e in eager)
            / 1e3 / n_steps,
            "graph_steps": graph_steps,
            "graph_kernels_per_step": len(kernels) / graph_steps,
            "graph_kernel_ms_per_step": busy_us / 1e3 / graph_steps,
            "graph_span_ms_per_step": span_us / 1e3 / graph_steps,
            "idle_share": (1.0 - busy_us / span_us) if span_us else None,
            "top_kernels": [{"name": k[:80], "count": n, "ms": us / 1e3}
                            for k, (n, us) in top]}


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
                rows.append((f"fig3b/thr_gbps/{s}/d{int(r['distance_km'])}km/"
                             f"msg{msg >> 10}KB", us[s],
                             f"{r['throughput_gbps']:.2f}Gbps"))
        for i, _ in enumerate(dists):
            sp = (part["matchrdma"][i]["throughput_gbps"]
                  / max(part["dcqcn"][i]["throughput_gbps"], 1e-9))
            best_speedup = max(best_speedup, sp)
    rows.append(("fig3b/max_speedup_vs_dcqcn", 0.0,
                 f"{best_speedup:.1f}x (paper: up to 20x)"))
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
            rows.append((f"fig3c/peak_buffer_mb/{s}/d{int(d)}km", us,
                         f"{r['peak_buffer_mb']:.1f}MB p99={r['p99_buffer_mb']:.1f}"))
            rows.append((f"fig3d/pause_ratio/{s}/d{int(d)}km", us,
                         f"{r['pause_ratio']:.4f}"))
            base[(s, d)] = r
    for d in dists:
        m, dq = base[("matchrdma", d)], base[("dcqcn", d)]
        rows.append((f"fig3c/buffer_reduction/d{int(d)}km", 0.0,
                     f"peak {-100 * (1 - m['peak_buffer_mb'] / max(dq['peak_buffer_mb'], 1e-9)):+.1f}% "
                     f"p99 {-100 * (1 - m['p99_buffer_mb'] / max(dq['p99_buffer_mb'], 1e-9)):+.1f}% "
                     f"(paper: -62.7% peak)"))
        rows.append((f"fig3d/pause_reduction/d{int(d)}km", 0.0,
                     f"{-100 * (1 - m['pause_ratio'] / max(dq['pause_ratio'], 1e-9)):+.1f}% "
                     f"(paper: -94.1%)"))
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
            rows.append((f"fig3e/avg_fct_us/{s}/msg{msg >> 10}KB", us,
                         f"{r['avg_fct_us']:.0f}us"))
    for i, msg in enumerate(msgs):
        imp = 100 * (1 - res["matchrdma"][i] / max(res["dcqcn"][i], 1e-9))
        rows.append((f"fig3e/fct_improvement/msg{msg >> 10}KB", 0.0,
                     f"{imp:+.1f}% vs dcqcn (paper: +31.5..43.9%)"))
    return rows


FIGURES = {"fig3b": fig3b_throughput, "fig3cd": fig3cd_buffer_pause,
           "fig3e": fig3e_fct}


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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    fig = Figure(args.figure, dev, args.horizon_us, args.profile_steps)
    rows = FIGURES[args.figure](fig, args.full)
    for name, value, note in rows:
        print(f"{name},{value:.1f},{note}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for r in fig.records:
        line = (f"{r['figure']} {r['scheme']}: {r['cells']} cells x "
                f"{r['steps']} steps, wall {r['wall_s']:.2f} s, "
                f"{r['cell_steps_per_s']:.0f} cell-steps/s")
        if "idle_share" in r:
            line += (f", device {r['device_ms_per_step']:.4f} ms/step, "
                     f"{r['kernels_per_step']:.0f} kernels/step "
                     f"({r['kernel_ms_per_step']:.4f} ms), idle "
                     f"{100 * r['idle_share']:.1f}%")
        print(line + f" [{kind}]", flush=True)
    out = {"figure": args.figure, "full": args.full, "device": kind,
           "horizon_us": args.horizon_us, "rows": rows, "schemes": fig.records}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
