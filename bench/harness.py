"""One run of one cell: the cell's files found by name, its driver run, its
metrics read, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the names in ``BENCHMARK.json``:

* ``bench/configs/<config>.json``: the configuration as run;
* ``bench/mixes/<traffic>.json``: the mix's parameters, and the driver
  (``bench/drivers/<driver>.py``) that runs them;
* ``bench/workloads/<cell>.json``: the cell's limits on the numbers that
  decide ``correct``;
* ``bench/metrics/<metric>.py``: ``read(run)``, the metric's value in a run
  or None where the run holds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names, whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bm: Optional[dict] = None) -> dict:
    bm = bm or benchmark()
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bm['workloads']]}")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(BENCH / "mixes" / f"{name}.json")


def limits(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")["limits"]


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"bench.drivers.{name}")


def metric(name: str) -> ModuleType:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell_name: str, traced: bool, bm: dict) -> list:
    """The cell's metrics: its end-to-end ones, or with a trace its per-layer ones."""
    return [m for m in bm["per_layer" if traced else "end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list:
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def run(cell_name: str, seed: int, seconds: float, traced: bool, device, t_start: float,
        bm: Optional[dict] = None, fault: Optional[str] = None,
        cfg: Optional[dict] = None, mx: Optional[dict] = None,
        lim: Optional[dict] = None) -> dict:
    """Runs the cell once and returns its result (the contract's keys, and
    ``compared`` last). ``t_start`` is the process's start on the host clock
    (``time.perf_counter``); ``cfg``, ``mx`` and ``lim`` stand in for the
    cell's files (the CPU tests run small copies of them)."""
    import torch

    bm = bm or benchmark()
    w = cell(cell_name, bm)
    cfg = cfg or config(w["config"])
    mx = mx or mix(w["traffic"])
    lim = lim or limits(cell_name)
    rec = driver(mx["driver"]).run(cfg, mx, seed, seconds, traced, device, fault=fault)
    r = SimpleNamespace(cfg=cfg, mix=mx, setup_s=rec["window_start"] - t_start, **rec)
    metrics = {}
    for m in metrics_of(cell_name, traced, bm):
        value = metric(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    out = {"correct": False, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                      "count": w["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}}
    if traced and rec["trace"] is not None:
        t = rec["trace"]
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = t.breakdown()
    compared = {k: {"value": v, "limit": lim[k]} for k, v in rec["gaps"].items() if k in lim}
    missing = sorted(set(lim) - set(compared))
    if missing:
        raise ValueError(f"the run gave no reading of {missing}")
    out["correct"] = rec["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    out["compared"] = compared
    return out
