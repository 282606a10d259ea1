"""Runs cells of the benchmark one after another, each run a process of its
own, as a check runs them, and keeps every result line.

    python3 bench/tools/sets.py --seconds 30 --out build/sets.jsonl \
        CELL:SEED:TRACE [CELL:SEED:TRACE ...]

Each run is ``python3 bench/run.py --workload CELL --seed SEED --seconds S
--trace TRACE``. Every run's exit code, wall seconds, result line and the
end of its standard error go to one JSON line of ``--out``; a short line
per run is printed, and the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+", help="CELL:SEED:TRACE")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print("card:", card(), flush=True)
    worst = 0
    for spec in args.runs:
        cell, seed, trace = spec.rsplit(":", 2)
        cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", cell, "--seed",
               seed, "--seconds", str(args.seconds), "--trace", trace]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        result = None
        if p.returncode == 0 and lines:
            result = json.loads(lines[-1])
        rec = {"cell": cell, "seed": int(seed), "trace": int(trace), "rc": p.returncode,
               "wall_s": wall, "result": result, "stderr": p.stderr[-3000:]}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = "no result"
        if result is not None:
            short = json.dumps({"correct": result["correct"],
                                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                                "peak_gb": result["device"]["memory_peak_bytes"] / 1e9,
                                "busy_s": result["device"].get("busy_s"),
                                "window_s": result["device"].get("window_s"),
                                "compared": {k: v["value"] for k, v in result["compared"].items()}})
        else:
            short += ": " + p.stderr[-1500:]
        print(f"{cell} seed {seed} trace {trace} rc {p.returncode} wall {wall:.1f} s {short}",
              flush=True)
        worst = max(worst, p.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
