"""Tune a netsim controller knob on the card: the gradient tuner against the
zeroth-order bracket search.

    PYTHONPATH=src python -m repro_torch.launch.grad_tune \
        [--variant compare|headroom|slot|baseline|grad|grad-headroom|grad-slot] \
        [--scheme matchrdma] [--dists-km 100,1000] [--horizon-us 20000] \
        [--iters 4] [--grad-steps 8] [--adversarial] [--remat-steps K] \
        [--device cpu]

The torch twin of ``benchmarks/hillclimb.py``'s ``netsim_tune`` (``--variant
headroom|slot|baseline``: each iteration runs a population of five knob
values x the distance grid as one ``run_experiment_batch`` launch in
metrics mode and halves the bracket around the best; ``grad*``: Adam
through the soft-step engine, ``netsim.grad_tune.tune``), printing the same
``iter ...`` / ``best ...`` lines, and of ``benchmarks/grad_tune_bench.py``
(``--variant compare``, the default: both tuners on one cell, matchrdma's
``budget_headroom`` on the congestion workload, and each one's evaluations
to reach the weaker final objective; printed as a JSON record, written
nowhere; it exits non-zero unless the grad tuner reaches the bracket
search's objective in fewer evaluations, as the benchmark asserts).
``--adversarial`` runs the tuner as an attacker: it ascends the
``impaired`` channel's knobs (``netsim.grad_tune.ADVERSARIAL_BOUNDS``)
against the scheme. ``--remat-steps K`` checkpoints each block of K steps
of the backward (``NetConfig.remat_steps``).

Each Adam step prints its wall seconds and device milliseconds (CUDA events
around the step's forward and backward; on the CPU, host milliseconds).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch.config.net import NetConfig
from repro_torch.device import resolve_device
from repro_torch.netsim.grad_tune import ADVERSARIAL_BOUNDS, KNOB_BOUNDS, tune
from repro_torch.netsim.runner import run_experiment_batch
from repro_torch.netsim.workload import congestion_workload

BRACKET_KNOB = {"headroom": "budget_headroom", "slot": "slot_us",
                "baseline": "budget_headroom"}
GRAD_KNOB = {"grad": "budget_headroom", "grad-headroom": "budget_headroom",
             "grad-slot": "slot_us"}
VARIANTS = ("compare",) + tuple(BRACKET_KNOB) + tuple(GRAD_KNOB)


class StepTimer:
    """Wall seconds and device ms of each Adam step: ``start()`` before
    ``tune``, then ``tune``'s ``on_step`` hook after each step's backward
    (CUDA events on the card, the host clock on the CPU)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.wall_s, self.device_ms = [], []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self.last = self._mark()

    def on_step(self, t: int, seconds: float) -> None:
        now = self._mark()
        if self.cuda:
            now.synchronize()
            ms = self.last.elapsed_time(now)
        else:
            ms = (now - self.last) * 1e3
        self.last = now
        self.wall_s.append(seconds)
        self.device_ms.append(ms)
        print(f"  adam step {t}: wall {seconds:.3f} s, device {ms:.1f} ms",
              flush=True)


def netsim_tune(variant: str, iters: int = 4, scheme: str = "matchrdma",
                dists: Sequence[float] = (100.0, 1000.0),
                horizon_us: float = 80_000.0, grad_steps: int = 8,
                device=None, adversarial: bool = False, remat_steps: int = 0,
                timer: Optional[StepTimer] = None):
    """One tuner on one cell; returns ``(best_knob_value, best_score,
    sim_evals_per_cell)`` as ``benchmarks.hillclimb.netsim_tune`` does (the
    adversarial grad variant returns the first knob's value). ``timer``
    receives the grad tuner's per-step timings."""
    dev = resolve_device(device)
    base = NetConfig(remat_steps=remat_steps)
    if variant.startswith("grad"):
        knobs = (tuple(ADVERSARIAL_BOUNDS) if adversarial
                 else (GRAD_KNOB[variant],))
        if timer is not None:
            timer.start()
        res = tune(knobs=knobs, scheme=scheme, dists=dists,
                   horizon_us=horizon_us, steps=grad_steps, verbose=True,
                   adversarial=adversarial, base_cfg=base, device=dev,
                   on_step=timer.on_step if timer is not None else None)
        print(f"best {' '.join(f'{k}={res.knobs[k]:.4g}' for k in knobs)} "
              f"score={res.objective:.2f} ({res.sim_evals} evals/cell)",
              flush=True)
        return res.knobs[knobs[0]], res.objective, res.sim_evals

    knob = BRACKET_KNOB[variant]
    lo, hi = KNOB_BOUNDS[knob]
    wl = congestion_workload()
    best = None
    evals = 0
    center = (lo + hi) / 2.0
    span = (hi - lo) / 2.0
    for it in range(iters):
        # a fixed population: clipping at a wall may repeat a value, but the
        # batch keeps its shape
        candidates = sorted(max(lo, min(hi, center + f * span))
                            for f in (-1.0, -0.5, 0.0, 0.5, 1.0))
        t0 = time.time()
        cfgs = [dataclasses.replace(base, distance_km=d, **{knob: val})
                for val in candidates for d in dists]
        rows = run_experiment_batch(cfgs, wl, scheme, horizon_us,
                                    trace_mode="metrics", device=dev)
        scores = {}
        for j, val in enumerate(candidates):
            cell = rows[j * len(dists):(j + 1) * len(dists)]
            thr = sum(r["throughput_gbps"] for r in cell) / len(cell)
            buf = sum(r["p99_buffer_mb"] for r in cell) / len(cell)
            scores[val] = thr - 0.5 * buf
        evals += len(candidates)
        val, score = max(scores.items(), key=lambda kv: kv[1])
        dt = time.time() - t0
        print(f"iter {it}: {knob}={val:.4g} score={score:.2f} "
              f"({len(candidates)}x{len(dists)} cells in {dt:.1f}s)",
              flush=True)
        if best is None or score > best[1]:
            best = (val, score)
        center, span = val, span / 2.0
    print(f"best {knob}={best[0]:.4g} score={best[1]:.2f}", flush=True)
    return best[0], best[1], evals


def compare(dists: Sequence[float] = (100.0, 1000.0),
            horizon_us: float = 20_000.0, iters: int = 4,
            grad_steps: int = 8, scheme: str = "matchrdma", device=None,
            remat_steps: int = 0) -> dict:
    """Both tuners on one cell (``benchmarks.grad_tune_bench.run``): each
    one's final true objective, evaluations, wall time, and evaluations to
    reach the weaker of the two finals. The grad tuner is charged 2 per Adam
    step up to the last one that still raised the surrogate, + 1."""
    from repro_torch.netsim import grad_tune

    dev = resolve_device(device)
    t0 = time.time()
    hc_val, hc_score, hc_evals = netsim_tune(
        "headroom", iters=iters, scheme=scheme, dists=dists,
        horizon_us=horizon_us, device=dev, remat_steps=remat_steps)
    hc_wall = time.time() - t0

    timer = StepTimer(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    timer.start()
    res = grad_tune.tune(knobs=("budget_headroom",), scheme=scheme,
                         dists=dists, horizon_us=horizon_us,
                         steps=grad_steps, verbose=True, device=dev,
                         base_cfg=NetConfig(remat_steps=remat_steps),
                         on_step=timer.on_step)
    grad_wall = time.time() - t0

    target = min(hc_score, res.objective)
    grad_to_target = res.sim_evals
    if res.objective >= target:
        surr = [h["surrogate"] for h in res.history]
        last_gain = max((i for i in range(1, len(surr))
                         if surr[i] > surr[i - 1] + 1e-6), default=0)
        grad_to_target = 2 * (last_gain + 1) + 1
    return {
        "grid": {"bench": "grad_tune_vs_hillclimb", "scheme": scheme,
                 "knob": "budget_headroom", "dists_km": list(dists),
                 "horizon_us": horizon_us, "hillclimb_iters": iters,
                 "grad_steps": grad_steps},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "hillclimb": {"knob": hc_val, "objective": hc_score,
                      "sim_evals": hc_evals, "wall_s": hc_wall},
        "grad_tuner": {"knob": res.knobs["budget_headroom"],
                       "objective": res.objective,
                       "sim_evals": res.sim_evals, "wall_s": grad_wall,
                       "adam_wall_s": timer.wall_s,
                       "adam_device_ms": timer.device_ms,
                       "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                          if dev.type == "cuda" else None),
                       "surrogate": [h["surrogate"] for h in res.history]},
        "target_objective": target,
        "evals_to_target": {"hillclimb": hc_evals,
                            "grad_tuner": grad_to_target},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="compare", choices=VARIANTS)
    ap.add_argument("--scheme", default="matchrdma")
    ap.add_argument("--dists-km", default="100,1000")
    ap.add_argument("--horizon-us", type=float, default=None,
                    help="default: 20 ms for compare, 80 ms otherwise, as "
                         "the JAX benchmarks")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--grad-steps", type=int, default=8)
    ap.add_argument("--adversarial", action="store_true")
    ap.add_argument("--remat-steps", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dists = tuple(float(d) for d in args.dists_km.split(","))
    dev = resolve_device(args.device)
    if args.variant == "compare":
        if args.adversarial:
            ap.error("--adversarial takes a grad* variant")
        rec = compare(dists, args.horizon_us or 20_000.0, args.iters,
                      args.grad_steps, args.scheme, dev, args.remat_steps)
        hc, gd = rec["hillclimb"], rec["grad_tuner"]
        print(f"hillclimb:  obj={hc['objective']:.3f} evals={hc['sim_evals']} "
              f"knob={hc['knob']:.4g} ({hc['wall_s']:.1f}s)")
        print(f"grad_tuner: obj={gd['objective']:.3f} evals={gd['sim_evals']} "
              f"knob={gd['knob']:.4g} ({gd['wall_s']:.1f}s)")
        print(f"evals_to_target (obj {rec['target_objective']:.3f}): "
              f"hillclimb={rec['evals_to_target']['hillclimb']} "
              f"grad={rec['evals_to_target']['grad_tuner']}")
        print(json.dumps(rec))
        # grad_tune_bench.py's claim: the bracket search's objective, in
        # fewer evaluations
        if not (gd["objective"] >= hc["objective"] - 1e-6
                and rec["evals_to_target"]["grad_tuner"]
                < rec["evals_to_target"]["hillclimb"]):
            raise SystemExit("grad_tune: the grad tuner does not match the "
                             "bracket search's objective with fewer evaluations")
        return
    if args.adversarial and not args.variant.startswith("grad"):
        ap.error("--adversarial takes a grad* variant")
    timer = StepTimer(dev)
    netsim_tune(args.variant, args.iters, args.scheme, dists,
                args.horizon_us or 80_000.0, args.grad_steps, dev,
                args.adversarial, args.remat_steps, timer=timer)
    if timer.wall_s:
        print(f"adam: mean wall {sum(timer.wall_s) / len(timer.wall_s):.3f} s, "
              f"mean device {sum(timer.device_ms) / len(timer.device_ms):.1f} "
              f"ms a step")


if __name__ == "__main__":
    main()
