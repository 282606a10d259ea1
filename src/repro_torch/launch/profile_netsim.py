"""What a netsim step costs on the card in each streaming trace mode: the
price of window mode's ring and event ring over metrics mode.

    PYTHONPATH=src python -m repro_torch.launch.profile_netsim \
        [--schemes dcqcn,matchrdma] [--steps 4000] [--profile-steps 20]

The cell is the obs smoke grid of ``launch.netsim --figure obs`` (100 and
300 km, the congestion workload of 8 + 8 flows bursting from 2 to 8 ms;
B = 2), run for each scheme (default: all seven) in ``metrics`` mode,
``window`` mode without an event ring and ``window`` mode with a 32-slot
ring (a window of 256 steps throughout). Per mode it reads the kernels a
step of the mode's whole step (its bookkeeping included): eager steps on the
card under ``torch.profiler``, the kernels of ``--profile-steps`` more steps
of a run less those of the shorter run, over the steps added; and the
device ms a step: CUDA events around the graph replays of a ``--steps``-step
run (``simulate_batch``'s ``run_ms``). Prints a table and one JSON line.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.netsim import OBS_SLOTS, obs_grid
from repro_torch.netsim import ALL_SCHEMES, simulate_batch

MODES = {"metrics": ("metrics", 0), "window": ("window", 0),
         "window+events": ("window", OBS_SLOTS)}


def kernels_of(cfgs, wl, scheme, mode, steps, device) -> int:
    """CUDA kernels of one eager ``simulate_batch`` run of ``steps`` steps
    (set-up included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    h = steps * cfgs[0].dt_us
    simulate_batch(cfgs, wl, scheme, h, trace_mode=mode, device=device, graph_block=0)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        simulate_batch(cfgs, wl, scheme, h, trace_mode=mode, device=device, graph_block=0)
        torch.cuda.synchronize(device)
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def measure(scheme: str, device, steps: int, profile_steps: int) -> dict:
    base, wl = obs_grid()
    out = {}
    for name, (mode, slots) in MODES.items():
        cfgs = [dataclasses.replace(c, event_ring_slots=slots) for c in base]
        k = (kernels_of(cfgs, wl, scheme, mode, 2 * profile_steps, device)
             - kernels_of(cfgs, wl, scheme, mode, profile_steps, device)) / profile_steps
        timing: dict = {}
        simulate_batch(cfgs, wl, scheme, steps * cfgs[0].dt_us, trace_mode=mode,
                       device=device, profile=timing)
        out[name] = {"kernels_per_step": k, "device_ms_per_step": timing["run_ms"] / steps,
                     "capture_s": timing["capture_s"]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schemes", default=",".join(ALL_SCHEMES))
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--profile-steps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    res = {s: measure(s, dev, args.steps, args.profile_steps)
           for s in args.schemes.split(",")}
    kind = torch.cuda.get_device_name(dev)
    print(f"{'scheme':10s} " + " ".join(f"{m:>24s}" for m in MODES) + f"   [{kind}]")
    for s, r in res.items():
        print(f"{s:10s} " + " ".join(
            f"{r[m]['kernels_per_step']:8.1f} k {r[m]['device_ms_per_step']:8.4f} ms"
            for m in MODES))
    out = {"device": kind, "cells": 2, "steps": args.steps, "schemes": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
