"""Geo-distributed training over MatchRDMA through the port's netsim: the
torch twin of ``examples/geo_training_sim.py``.

    PYTHONPATH=src python -m repro_torch.launch.geo_training \
        [--arch deepseek-67b] [--distances-km 100] [--schemes dcqcn,matchrdma] \
        [--lossy] [--horizon-us US] [--device cpu]

Takes an arch of the registry (any of the ten: the traffic model needs its
config only), derives its inter-DC traffic from the AICB-like model
(``repro_torch.traffic``) for the production multi-pod mesh
(``get_parallel_config(arch, multi_pod=True)``: 2 pods x 16 x 16, two
AI-DCs) at ``TrainConfig(256, 4096)``, with ``pod_compression`` none and
int8, and runs that traffic through the netsim at 120 ms (24,000 steps),
``trace_mode="metrics"``, one ``[B]`` batch over the distance grid per
scheme (schemes by registered name). It prints the example's table: OTN
utilisation, the comm time it implies, peak buffer and pause ratio.

``--lossy`` adds the example's lossy long haul: the same traffic over three
OTN links (300 Gb/s) under the ``bernoulli_loss`` channel, loss 0.002 / 0.01
/ 0.03 in bursts of about 4 steps at each distance, for dcqcn and sdr_rdma
(one batch each), with goodput, wire rate, retransmit share, p99 repair
latency and the "sdr_rdma repairs Nx faster" lines.

``--horizon-us`` cuts the horizon (the rows then differ from the example's).
Runs on the GPU unless ``--device cpu``; without a GPU it raises. The last
line is JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.config.net import NetConfig
from repro_torch.config.registry import get_model_config, get_parallel_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.netsim import get_scheme, run_experiment_batch
from repro_torch.traffic import iteration_profile, step_traffic, training_workload

HORIZON_US = 120_000.0
TRAIN = TrainConfig(global_batch=256, seq_len=4096)
LOSS_RATES = (0.002, 0.01, 0.03)
LOSSY_SCHEMES = ("dcqcn", "sdr_rdma")


def _run(nets, wl, scheme, horizon_us, device, records, **kw):
    launches: list = []
    t0 = time.perf_counter()
    rows = run_experiment_batch(nets, wl, scheme, horizon_us, trace_mode="metrics",
                                device=device, profile=launches, **kw)
    wall_s = time.perf_counter() - t0
    steps = launches[0]["steps"]
    rec = {"scheme": get_scheme(scheme).name, "cells": len(nets), "steps": steps,
           "wall_s": wall_s, "capture_s": sum(p["capture_s"] for p in launches),
           "channel": kw.get("channel") or "ideal"}
    rec["device_ms_per_step" if device.type == "cuda" else "cpu_ms_per_step"] = (
        sum(p["run_ms"] for p in launches) / max(steps * len(launches), 1))
    records.append(rec)
    return rows


def training_table(arch: str, distances, schemes, horizon_us: float,
                   device: torch.device, records: list) -> dict:
    """The example's main table for each ``pod_compression``: ``{compression:
    {"traffic": {...}, "rows": {scheme: [row per distance]}}}``."""
    model = get_model_config(arch)
    nets = [NetConfig(distance_km=d) for d in distances]
    out = {}
    for compress in ("none", "int8"):
        par = get_parallel_config(arch, multi_pod=True, pod_compression=compress)
        t = step_traffic(model, par, TRAIN)
        prof = iteration_profile(model, par, TRAIN)
        print(f"\n=== {arch}  pod_compression={compress} ===")
        print(f"inter-DC bytes/step : {t.inter_pod_bytes / 1e9:10.1f} GB "
              f"(hierarchical reduce-scatter exchange)")
        print(f"compute time/step   : {t.iter_time_estimate_s:10.2f} s "
              f"(512 chips @ 40% MFU)")
        print(f"exposed comm (ideal): {prof.comm_us / 1e6:10.2f} s "
              f"({100 * t.comm_frac:.1f}% overhead at full OTN rate)")
        wl = training_workload(model, par, TRAIN, num_flows=16)
        res = {}
        for scheme in schemes:
            rows = _run(nets, wl, scheme, horizon_us, device, records)
            res[get_scheme(scheme).name] = rows
            for r in rows:
                eff = r["throughput_gbps"] / (16 * 100)
                t_comm = t.inter_pod_bytes / max(r["throughput_gbps"] * 1e9 / 8, 1)
                print(f"  {r['scheme']:10s} @{int(r['distance_km']):>5d}km: "
                      f"OTN util {100 * eff:5.1f}%  "
                      f"-> comm time {t_comm:7.2f} s  "
                      f"buf {r['peak_buffer_mb']:7.1f} MB  "
                      f"pause {r['pause_ratio']:.3f}", flush=True)
        out[compress] = {"traffic": {"inter_pod_bytes": t.inter_pod_bytes,
                                     "iter_time_estimate_s": t.iter_time_estimate_s,
                                     "comm_us": prof.comm_us,
                                     "comm_frac": t.comm_frac},
                         "rows": res}
    return out


def lossy_long_haul(arch: str, distances, horizon_us: float,
                    device: torch.device, records: list) -> dict:
    """sdr_rdma vs e2e dcqcn on a lossy long haul: the training traffic over
    a thin (3 OTN links) long haul, a loss-rate grid per distance, one
    batch per scheme. Returns ``{"rows": {scheme: rows}, "repair_speedup":
    [...]}``."""
    model = get_model_config(arch)
    par = get_parallel_config(arch, multi_pod=True)
    wl = training_workload(model, par, TRAIN, num_flows=16)
    # a thin long haul (3 OTN links = 300 Gbps) so the training traffic
    # contends for the line: on an overprovisioned pipe both transports
    # repair within a step and the reliability layer has nothing to show
    nets = [NetConfig(distance_km=d, num_otn_links=3, loss_rate=lr,
                      loss_burst_len=4.0)
            for d in distances for lr in LOSS_RATES]
    print("\n=== lossy long haul (bernoulli_loss channel, "
          "Gilbert-Elliott bursts of ~4 steps, 3 OTN links) ===")
    print(f"{'scheme':10s} {'km':>6s} {'loss':>6s} {'goodput':>9s} "
          f"{'wire':>9s} {'retx%':>6s} {'p99 repair':>12s}")
    results = {}
    for scheme in LOSSY_SCHEMES:
        rows = _run(nets, wl, scheme, horizon_us, device, records,
                    channel="bernoulli_loss")
        results[scheme] = rows
        for r, net in zip(rows, nets):
            print(f"{r['scheme']:10s} {int(net.distance_km):>6d} "
                  f"{net.loss_rate:>6.3f} {r['goodput_gbps']:>7.1f}Gb "
                  f"{r['wire_gbps']:>7.1f}Gb {100 * r['retx_frac']:>5.2f}% "
                  f"{r['p99_repair_latency_us']:>10.0f}us", flush=True)
    speedup = []
    for i, net in enumerate(nets):
        dc = results["dcqcn"][i]["p99_repair_latency_us"]
        sdr = results["sdr_rdma"][i]["p99_repair_latency_us"]
        if dc > 0 and sdr > 0:
            x = dc / max(sdr, 1e-9)
            speedup.append({"distance_km": net.distance_km,
                            "loss_rate": net.loss_rate, "x": x})
            print(f"# @{int(net.distance_km)}km loss={net.loss_rate}: "
                  f"sdr_rdma repairs {x:.0f}x faster (p99)")
    return {"rows": results, "repair_speedup": speedup}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-67b", choices=list_archs())
    ap.add_argument("--distances-km", default="100.0",
                    help="comma-separated inter-DC distance grid")
    ap.add_argument("--schemes", default="dcqcn,matchrdma",
                    help="comma-separated registered scheme names")
    ap.add_argument("--lossy", action="store_true",
                    help="add the lossy long haul: sdr_rdma vs dcqcn goodput "
                         "and repair latency over a loss grid (bernoulli_loss)")
    ap.add_argument("--horizon-us", type=float, default=HORIZON_US,
                    help="simulated horizon (default: the example's 120 ms)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    distances = [float(d) for d in args.distances_km.split(",")]
    schemes = [get_scheme(s).name for s in args.schemes.split(",")]
    records: list = []
    out = {"arch": args.arch, "distances_km": distances, "horizon_us": args.horizon_us,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    out["training"] = training_table(args.arch, distances, schemes,
                                     args.horizon_us, dev, records)
    if args.lossy:
        out["lossy"] = lossy_long_haul(args.arch, distances, args.horizon_us,
                                       dev, records)
    out["runs"] = records
    for r in records:
        ms = r.get("device_ms_per_step", r.get("cpu_ms_per_step"))
        print(f"{r['scheme']} [{r['channel']}]: {r['cells']} cells x {r['steps']} "
              f"steps, wall {r['wall_s']:.2f} s (capture {r['capture_s']:.2f} s), "
              f"{ms:.4f} ms/step [{out['device']}]", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
