"""The JAX package's netsim figure rows at the grids and horizons the card
runs, recorded in ``torch_figure_reference.json``, and the rule that holds
the port's rows against them.

    PYTHONPATH=src python tests/torch_figure_reference.py [--jobs 4]

``main`` (which imports JAX inside it) runs the JAX package's own runner,
``repro.netsim.run_experiment_batch``, on every batch of the port's figure
functions (``repro_torch.launch.netsim.FIGURES``: Fig. 3b and 3c/d on their
full grids, 3e, scheme_compare at ``chip_smoke.py``'s 22 ms, topology,
impairment, sites and failover at their defaults) and of
``launch.geo_training --distances-km 10,1000 --lossy`` at 120 ms: the
port's functions build the configs, workloads and rows, JAX's runner
computes each batch. It does so once on ``NetConfig``'s defaults and once
for each of ``ULPS``, with ``link_gbps`` (100.0) moved by that many f32
ulps, and writes for each printed row its numbers in every run, their
envelope (least and largest over the runs), the base run's note, and the
base run's raw batches (which the tests replay through the port's figure
functions). Fig. 3b-e's base rows are also compared with
``benchmarks/figures.py``'s own at the same grids (``figures_py``).

Everything else here imports no JAX: ``chip_smoke.py`` reads the file on the
card, where there is no JAX, and holds each row with ``hold``: a cell's
number must lie inside JAX's envelope widened by the port's row limits
(``COLUMN_REL`` of the value above a floor, ``PAUSE_ABS`` for shares) and
one unit of its last printed digit; a derived row (max speedup, buffer and
pause reduction, FCT improvement, the summaries, the repair speedups) is
recomputed from its parts, JAX's in each run and the port's with the parts'
widening carried through, and the two must meet. A row outside is a
finding: traced to the step where the runs part, it is named in
``FIGURE_PARTS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import re
import sys
import time
from contextlib import ExitStack, redirect_stdout
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = Path(__file__).with_suffix(".json")

# The perturbed runs: NetConfig.link_gbps moved by these many f32 ulps (7.6e-6
# at 100.0), so every capacity and every threshold derived from one moves by
# 1e-7 to 3e-7 relative: the size of the port's per-step rounding against
# XLA's (an FMA against two roundings), which decides a parting.
LINK_GBPS = 100.0
ULPS = (-4, -3, -2, -1, 1, 2, 3, 4)
# The port's row limits (tests/torch_parity.py COLUMN_REL and PAUSE_ABS,
# chip_smoke.py NETSIM_TOL): rates, buffers and latencies relative above a
# floor (NETSIM_FLOOR's 1e-4 Gbps and 100 B; one 5 us step for latencies),
# shares absolute.
COLUMN_REL = 1e-3
PAUSE_ABS = 1e-3
FLOORS = {"_gbps": 1e-4, "_mb": 1e-4, "_us": 5e3}
# the denominator floor of the port's ratio rows (max(x, 1e-9))
RATIO_FLOOR = 1e-9

# What the card holds: each figure of launch.netsim with (full, horizon us),
# and launch.geo_training's arguments.
HELD = {"fig3b": (True, 220_000.0), "fig3cd": (True, 100_000.0),
        "fig3e": (False, 200_000.0), "scheme_compare": (False, 22_000.0),
        "topology": (False, 20_000.0), "impairment": (False, 20_000.0),
        "sites": (False, 20_000.0), "failover": (False, 20_000.0)}
GEO = "geo_training"
GEO_ARGS = ("--distances-km", "10,1000", "--lossy")
GEO_H_US = 120_000.0

# Rows that the card's run puts outside the envelope, each traced to the step
# where its run parts from JAX's (tools/netsim_parting.py on the card's run:
# every leaf within TRACE_REL before it, and the port's step from JAX's state
# within STEP_REL at it, so both compute one step; an ulp of drift puts one
# run on each side of a hard threshold): row -> (step, the threshold that
# flips there, JAX's value of the thresholded quantity, the card's). Derived
# rows follow their parts (the 64 KB FCT improvement, the summaries).
_LATCH = "flow 4's completion latch: delivered >= total_bytes = 1,048,576 B"
FIGURE_PARTS: dict = {
    "fig3e/avg_fct_us/dcqcn/msg64KB": (6712, _LATCH, 1048576.0, 1048575.875),
    "fig3e/avg_fct_us/themis/msg64KB": (6773, _LATCH, 1048576.625, 1048574.5625),
    "impairment/geopipe/loss0.02/jitter0us": (
        142, "src-OTN -> sender PFC at step 141: sum(q_src) > xoff_otn = 1e7 B "
        "(0.1 x 2D x C_otn at 50 km)", 9999999.0, 10000002.0),
    "impairment/sdr_rdma/loss0.02/jitter0us": (
        558, "sdr_rdma's degradation EWMA counts a hit where inter-DC loss "
        "notifications > 0 B: flow 0's notification of bytes lost at step 508, "
        "the residue of its drained pipe", 0.0, 1.9976382),
}


def link_gbps(ulps: int) -> float:
    """``LINK_GBPS`` moved by ``ulps`` f32 ulps."""
    x = np.float32(LINK_GBPS)
    step = np.float32(np.inf if ulps > 0 else -np.inf)
    for _ in range(abs(ulps)):
        x = np.nextafter(x, step)
    return float(x)


# --- the rule -------------------------------------------------------------

def widening(field: str, x: float) -> float:
    """The port's limit on one cell number (see ``COLUMN_REL``)."""
    if not math.isfinite(x):
        return 0.0
    for suffix, floor in FLOORS.items():
        if field.endswith(suffix):
            return COLUMN_REL * max(abs(x), floor)
    return PAUSE_ABS


def unit(spec: str, x: float) -> float:
    """One unit of the last digit that ``format(x, spec)`` prints."""
    m = re.search(r"\.(\d+)([fg])", spec)
    if not m or not math.isfinite(x):
        return 0.0
    p = int(m.group(1))
    if m.group(2) == "f":
        return 10.0 ** -p
    return 10.0 ** (math.floor(math.log10(abs(x))) - max(p, 1) + 1) if x else 0.0


@dataclasses.dataclass(frozen=True)
class Iv:
    """A number and the interval the rule allows it (``lo`` to ``hi``)."""
    v: float
    lo: float
    hi: float

    @staticmethod
    def point(v: float) -> "Iv":
        return Iv(v, v, v)


def _finite(*ivs) -> bool:
    return all(math.isfinite(x) for iv in ivs for x in (iv.v, iv.lo, iv.hi))


def _ratio(a: Iv, b: Iv) -> Iv:
    """a / max(b, 1e-9) of two non-negative numbers."""
    v = a.v / max(b.v, RATIO_FLOOR)
    if not _finite(a, b):
        return Iv.point(v)
    return Iv(v, a.lo / max(b.hi, RATIO_FLOOR), a.hi / max(b.lo, RATIO_FLOOR))


def _reduction(r: Iv, sign: float) -> Iv:
    """-100 (1 - r) (sign 1, a reduction) or 100 (1 - r) (sign -1, an
    improvement), as the port's rows compute them."""
    f = (lambda x: -100 * (1 - x)) if sign > 0 else (lambda x: 100 * (1 - x))
    lo, hi = sorted((f(r.lo), f(r.hi)))
    return Iv(f(r.v), lo, hi)


def _max(ivs) -> Iv:
    return Iv(max(i.v for i in ivs), max(i.lo for i in ivs), max(i.hi for i in ivs))


def _mean(ivs) -> Iv:
    n = len(ivs)
    return Iv(sum(i.v for i in ivs) / n, sum(i.lo for i in ivs) / n,
              sum(i.hi for i in ivs) / n)


def _at_argmax(keys, vals) -> Iv:
    """``vals`` at the first largest of ``keys`` (``max(rows, key=...)``), and
    every value whose key the rule lets be the largest."""
    first = max(range(len(keys)), key=lambda i: keys[i].v)
    top = max(k.lo for k in keys)
    can = [i for i, k in enumerate(keys) if k.hi >= top]
    return Iv(vals[first].v, min(vals[i].lo for i in can), max(vals[i].hi for i in can))


def _km(name: str) -> float:
    return float(re.search(r"/d([\d.]+)km", name).group(1))


def derived_parts(name: str, names) -> list:
    """The rows that derived row ``name`` is computed from (``names``: the rows
    present), or [] for a cell row."""
    fig = name.split("/")[0]
    if name == "fig3b/max_speedup_vs_dcqcn":
        m = [n for n in names if n.startswith("fig3b/thr_gbps/matchrdma/")]
        return m + [n.replace("/matchrdma/", "/dcqcn/") for n in m]
    for derived, cell in (("fig3c/buffer_reduction/", "fig3c/peak_buffer_mb/{}/"),
                          ("fig3d/pause_reduction/", "fig3d/pause_ratio/{}/"),
                          ("fig3e/fct_improvement/", "fig3e/avg_fct_us/{}/"),
                          (f"{GEO}/repair_speedup/", f"{GEO}/lossy/{{}}/")):
        if name.startswith(derived):
            rest = name[len(derived):]
            pair = ("sdr_rdma", "dcqcn") if fig == GEO else ("matchrdma", "dcqcn")
            return [cell.format(s) + rest for s in pair]
    if "/summary/" in name:
        scheme = name.rsplit("/", 1)[1]
        return [n for n in names if n.startswith(f"{fig}/{scheme}/")]
    return []


def derive(name: str, field: str, get, names) -> Iv:
    """Field ``field`` of derived row ``name`` from its parts; ``get(row,
    field)`` gives a part's ``Iv``."""
    parts = derived_parts(name, names)
    if name == "fig3b/max_speedup_vs_dcqcn":
        half = len(parts) // 2
        return _max([_ratio(get(m, "throughput_gbps"), get(d, "throughput_gbps"))
                     for m, d in zip(parts[:half], parts[half:])])
    if "/summary/" not in name:
        num, den = parts
        if field == "repair_x":
            return _ratio(get(den, "p99_repair_latency_us"),
                          get(num, "p99_repair_latency_us"))
        col = {"peak_pct": "peak_buffer_mb", "p99_pct": "p99_buffer_mb",
               "pause_pct": "pause_ratio", "fct_pct": "avg_fct_us"}[field]
        return _reduction(_ratio(get(num, col), get(den, col)),
                          -1.0 if field == "fct_pct" else 1.0)
    col = {"mean_pause": "pause_ratio", "mean_thr_gbps": "throughput_gbps",
           "spray_entropy": "spray_entropy", "worst_peak_mb": "peak_buffer_mb",
           "retx_frac_worst": "retx_frac", "goodput_worst_gbps": "goodput_gbps",
           "p99_repair_worst_us": "p99_repair_latency_us",
           "thr_far_gbps": "throughput_gbps",
           "collapse_worst": "failover_collapse_frac",
           "recovery_worst_us": "failover_recovery_us"}[field]
    if field in ("collapse_worst", "recovery_worst_us"):
        parts = [p for p in parts if "/none/" not in p]
    ivs = [get(p, col) for p in parts]
    if field.startswith("mean_") or field == "spray_entropy":
        return _mean(ivs)
    if field == "thr_far_gbps":
        return max(zip(map(_km, parts), ivs), key=lambda t: t[0])[1]
    if field in ("goodput_worst_gbps", "p99_repair_worst_us"):
        return _at_argmax([get(p, "retx_frac") for p in parts], ivs)
    return _max(ivs)


def _card_iv(field: str, x: float) -> Iv:
    """A cell number of the port's and its limit (``widening``)."""
    t = widening(field, x)
    return Iv(x, max(x - t, 0.0), x + t) if math.isfinite(x) else Iv.point(x)


def _same(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def _close(a: float, b: float) -> bool:
    return _same(a, b) or abs(a - b) <= 1e-9 * max(abs(a), abs(b))


def envelope(ref_rows: dict, name: str, field: str, names) -> tuple:
    """JAX's least and largest value of one row's field over the runs; a
    derived row is recomputed in each run from that run's parts among
    ``names``."""
    if not derived_parts(name, names):
        vals = ref_rows[name]["values"][field]
    else:
        n_runs = len(ref_rows[name]["values"][field])
        vals = [derive(name, field, lambda r, f, k=k: Iv.point(ref_rows[r]["values"][f][k]),
                       names).v for k in range(n_runs)]
    finite = [v for v in vals if math.isfinite(v)]
    if len(finite) != len(vals):
        return vals[0], vals[0], vals
    return min(vals), max(vals), vals


def hold(card: dict, reference: dict, parts: dict = None) -> dict:
    """The port's rows ``card`` (``{row: {"values": {field: x}, "specs":
    {field: spec}}}``, in printed order) against one figure of the reference
    (``load()["figures"][name]``). Each field reads its distance from JAX's
    base value against its limit: the envelope's reach on that side, widened
    by the port's limit at the envelope's end (for a derived row, by the
    reach of its interval recomputed from the port's parts) and one printed
    unit; a row is inside when every field reads within its limit. The
    rows' names and order must be the reference's. Rows outside that
    ``parts`` (default ``FIGURE_PARTS``) names, or derived from such a row,
    count as parts."""
    parts = FIGURE_PARTS if parts is None else parts
    ref_rows = {r["name"]: r for r in reference["rows"]}
    names = list(card)
    out = {"rows": len(names), "inside": 0, "parts": [], "outside": [],
           "worst": None, "readings": {}}
    if names != list(ref_rows):
        missing = [n for n in ref_rows if n not in card]
        extra = [n for n in names if n not in ref_rows]
        out["outside"].append({"row": "(row names)", "missing": missing[:10],
                               "extra": extra[:10], "same_set": not missing and not extra})
        return out
    worst = (-1.0, None)
    for name in names:
        row = card[name]
        dparts = derived_parts(name, names)
        fields = {}
        for field, x in row["values"].items():
            lo, hi, vals = envelope(ref_rows, name, field, names)
            base = vals[0]
            if dparts:
                iv = derive(name, field, lambda r, f: _card_iv(f, card[r]["values"][f]), names)
                if not _close(iv.v, x):
                    fields[field] = {"value": x, "recomputed": iv.v, "lo": lo, "hi": hi,
                                     "dist": math.inf, "limit": 0.0}
                    continue
            spec = row["specs"].get(field, "")
            if not (math.isfinite(x) and math.isfinite(lo) and math.isfinite(hi)):
                dist, limit = (0.0 if _same(x, lo) and _same(x, hi) else math.inf), 0.0
            else:
                # the distance from JAX's base value against the envelope's
                # reach on that side, widened: for a cell number by its limit
                # at the envelope's end, for a derived one by the reach of
                # its interval recomputed from the port's parts
                up = x >= base
                dist, end = (x - base, hi) if up else (base - x, lo)
                widen = ((x - iv.lo if up else iv.hi - x) + unit(spec, x) if dparts
                         else widening(field, end) + unit(spec, end))
                limit = abs(end - base) + widen
            fields[field] = {"value": x, "lo": lo, "hi": hi, "dist": dist, "limit": limit}
        out["readings"][name] = fields
        bad = {f: r for f, r in fields.items() if not r["dist"] <= r["limit"]}
        if bad and (name in parts or any(p in parts for p in dparts)):
            out["parts"].append(name)
            continue
        for field, r in fields.items():
            ratio = (r["dist"] / r["limit"] if r["limit"] > 0
                     else 0.0 if r["dist"] == 0 else math.inf)
            if ratio > worst[0]:
                worst = (ratio, {"row": name, "field": field, **r})
        if not bad:
            out["inside"] += 1
        else:
            out["outside"].append({"row": name, **{f: {k: r[k] for k in (
                "value", "lo", "hi", "dist", "limit", "recomputed") if k in r}
                for f, r in bad.items()}})
    out["worst"] = worst[1] and {**worst[1], "reading_over_limit": worst[0]}
    return out


def summary(name: str, held: dict) -> str:
    """One line: rows held, inside, named parts, outside, the largest reading
    (over the rows not counted as parts)."""
    w = held["worst"]
    worst = (f"largest {w['row']} {w['field']}: {w['value']:.6g}, {w['dist']:.4g} from "
             f"JAX's base in [{w['lo']:.6g}, {w['hi']:.6g}] against {w['limit']:.4g} "
             f"({w['reading_over_limit']:.3f} of it)") if w else "no reading"
    return (f"{name} against JAX's rows: {held['rows']} rows held, {held['inside']} "
            f"inside, {len(held['parts'])} FIGURE_PARTS rows, "
            f"{len(held['outside'])} outside; {worst}")


def load(path: Path = REFERENCE) -> dict:
    with open(path) as f:
        return json.load(f)


def geo_values(out: dict) -> dict:
    """``launch.geo_training.main``'s result as held rows: the main table
    (throughput, peak buffer, pause ratio), the lossy long haul (goodput,
    wire rate, retransmit share, p99 repair latency) and the repair speedups."""
    from repro_torch.launch.netsim import kept

    rows = {}

    def keep(name, template, **values):
        note, nums, specs = kept(template, **values)
        rows[name] = {"values": nums, "specs": specs, "note": note}

    for compress, table in out["training"].items():
        for scheme, rs in table["rows"].items():
            for r in rs:
                keep(f"{GEO}/{compress}/{scheme}/d{r['distance_km']:g}km",
                     "thr={throughput_gbps:.4g}Gbps peak={peak_buffer_mb:.4g}MB "
                     "pause={pause_ratio:.4g}", **r)
    lossy = out["lossy"]["rows"]
    cells = [(d, lr) for d in out["distances_km"] for lr in (0.002, 0.01, 0.03)]
    for scheme, rs in lossy.items():
        for (d, lr), r in zip(cells, rs):
            keep(f"{GEO}/lossy/{scheme}/d{d:g}km/loss{lr:g}",
                 "goodput={goodput_gbps:.4g}Gbps wire={wire_gbps:.4g}Gbps "
                 "retx={retx_frac:.4g} p99={p99_repair_latency_us:.4g}us", **r)
    for x in out["lossy"]["repair_speedup"]:
        keep(f"{GEO}/repair_speedup/d{x['distance_km']:g}km/loss{x['loss_rate']:g}",
             "{repair_x:.4g}x", repair_x=x["x"])
    return rows


# --- recording JAX's rows (imports JAX) ---------------------------------------

def _plain(v):
    if isinstance(v, (bool, str)) or v is None:
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)) or np.ndim(v) == 0:
        return float(v)
    return [_plain(x) for x in np.asarray(v).tolist()]


def _jax_runner(ulps: int, batches: list):
    """A stand-in for the port's ``run_experiment_batch`` that runs the JAX
    package's on the same configs (``link_gbps`` moved by ``ulps``) and
    workloads; each batch's rows are appended to ``batches``."""
    from repro.config.base import NetConfig as JNetConfig
    from repro.netsim import run_experiment_batch as jrun
    from repro.netsim import workload as jwork

    link = link_gbps(ulps)

    def jax_workload(wl):
        if isinstance(wl, (list, tuple)):
            return [jax_workload(w) for w in wl]
        return jwork.Workload(tuple(jwork.FlowSpec(**dataclasses.asdict(f))
                                    for f in wl.flows))

    def run(cfgs, workload, scheme, horizon_us, *, device=None, profile=None,
            manifest_path=None, **kw):
        jcfgs = [JNetConfig(**{f: getattr(c, f) for f in c.__dataclass_fields__})
                 for c in cfgs]
        jcfgs = [dataclasses.replace(c, link_gbps=link) for c in jcfgs]
        rows = [{k: _plain(v) for k, v in r.items()} for r in
                jrun(jcfgs, jax_workload(workload), scheme, horizon_us, **kw)]
        batches.append({"scheme": scheme, "horizon_us": horizon_us, "rows": rows})
        if profile is not None:
            profile.append({"steps": cfgs[0].horizon_steps(horizon_us), "run_ms": 0.0,
                            "capture_s": 0.0})
        return rows

    return run


def record(name: str, ulps: int = 0, with_figures_py: bool = True,
           reduced: bool = False) -> dict:
    """One run of figure ``name`` through JAX's runner, ``link_gbps`` moved by
    ``ulps``: the held rows, the raw batches, the horizon; for Fig. 3b-e's
    base run also ``figures.py``'s own rows (unless ``with_figures_py`` is
    false). ``reduced``: the figure's reduced grid (not the card's)."""
    import torch

    from repro_torch.launch import geo_training
    from repro_torch.launch import netsim as launch

    batches: list = []
    run = _jax_runner(ulps, batches)
    t0 = time.perf_counter()
    with ExitStack() as stack:
        stack.enter_context(redirect_stdout(io.StringIO()))
        for mod in (launch, geo_training):
            stack.enter_context(mock.patch.object(mod, "run_experiment_batch", run))
        if name == GEO:
            out = geo_training.main([*GEO_ARGS, "--device", "cpu",
                                     "--horizon-us", str(GEO_H_US)])
            rows = geo_values(out)
        else:
            full, h = HELD[name]
            full = full and not reduced
            fig = launch.Figure(name, torch.device("cpu"), h, profile_steps=0)
            printed = launch.FIGURES[name](fig, full=full)
            rows = {n: dict(fig.values[n], note=note) for n, _, note in printed}
    (horizon,) = {b["horizon_us"] for b in batches}
    rec = {"figure": name, "ulps": ulps, "seconds": time.perf_counter() - t0,
           "horizon_us": horizon, "rows": rows, "batches": batches}
    if with_figures_py and ulps == 0 and name in ("fig3b", "fig3cd", "fig3e"):
        from benchmarks import figures
        full = HELD[name][0] and not reduced
        fn = getattr(figures, launch.FIGURES[name].__name__)
        jrows = fn(full=full) if name != "fig3e" else fn()
        rec["figures_py"] = {"rows": len(jrows), "apart": [
            [n, rows[n]["note"] if n in rows else None, note]
            for n, _, note in jrows if n not in rows or rows[n]["note"] != note]}
    return rec


def _worker_init():
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    torch.set_num_threads(1)


def _record_job(job: tuple) -> dict:
    return record(*job)


def assemble(recs: list) -> dict:
    """The file's figures from the runs' records."""
    figs = {}
    for name in [*HELD, GEO]:
        runs = {r["ulps"]: r for r in recs if r["figure"] == name}
        if not runs:
            continue
        order = [0, *ULPS]
        base = runs[0]
        rows = []
        for row, kept in base["rows"].items():
            values = {f: [runs[k]["rows"][row]["values"][f] for k in order]
                      for f in kept["values"]}
            rows.append({"name": row, "note": kept["note"], "specs": kept["specs"],
                         "values": values})
        for r in rows:
            for f in r["values"]:
                lo, hi, _ = envelope({x["name"]: x for x in rows}, r["name"], f,
                                     list(base["rows"]))
                r.setdefault("lo", {})[f], r.setdefault("hi", {})[f] = lo, hi
        figs[name] = {"horizon_us": base["horizon_us"],
                      "seconds": {str(k): runs[k]["seconds"] for k in order},
                      "rows": rows, "batches": base["batches"],
                      **({"figures_py": base["figures_py"]} if "figures_py" in base else {})}
    return figs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=str(REFERENCE))
    ap.add_argument("--reduced", action="store_true",
                    help="Fig. 3b-e's reduced grids at the paper's horizons, for "
                         "tools/netsim_fig_parity.py (not the card's file)")
    args = ap.parse_args(argv)
    import concurrent.futures
    import multiprocessing

    import jax
    import jaxlib

    names = ["fig3b", "fig3cd", "fig3e"] if args.reduced else [*HELD, GEO]
    jobs = [(n, k, True, args.reduced) for n in names for k in (0, *ULPS)]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init) as pool:
        recs = []
        for rec in pool.map(_record_job, jobs):
            print(f"{rec['figure']} ulps {rec['ulps']:+d}: {len(rec['rows'])} rows, "
                  f"{rec['seconds']:.1f} s", flush=True)
            recs.append(rec)
    doc = {"command": " ".join(["PYTHONPATH=src python tests/torch_figure_reference.py",
                                *(argv if argv is not None else sys.argv[1:])]),
           "jax": jax.__version__, "jaxlib": jaxlib.__version__, "numpy": np.__version__,
           "input": "NetConfig.link_gbps", "ulps": [0, *ULPS],
           "link_gbps": [link_gbps(k) for k in (0, *ULPS)],
           "rule": {"COLUMN_REL": COLUMN_REL, "PAUSE_ABS": PAUSE_ABS, "FLOORS": FLOORS},
           "seconds": time.perf_counter() - t0, "figures": assemble(recs)}
    Path(args.out).write_text(json.dumps(doc, separators=(",", ":")) + "\n")
    for name, fig in doc["figures"].items():
        apart = fig.get("figures_py", {}).get("apart")
        print(f"{name}: {len(fig['rows'])} rows at {fig['horizon_us']} us"
              + (f"; figures.py's rows apart: {apart}" if apart is not None else ""))
    return doc


if __name__ == "__main__":
    main()
