#!/usr/bin/env python3
"""The port's Fig. 3 rows against the JAX package's, at the paper's horizons.

    PYTHONPATH=src python tools/netsim_fig_parity.py [--figure fig3b] \
        [--full] [--device cpu] [--out rows.json]

Runs ``benchmarks/figures.py``'s figure functions (JAX, on its default
backend) and ``repro_torch.launch.netsim``'s (on ``--device``, the GPU by
default) on the same grids and horizons, prints each row of both side by
side, marks the rows whose printed values differ, and ends with one JSON
line (the rows, the counts and both sides' wall seconds; also written to
``--out`` when given). Every figure by default. The CPU tests hold the same
rows at cut horizons (tests/test_torch_netsim_figures.py); this is the
uncut comparison, which takes tens of minutes on the CPU.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks import figures  # noqa: E402
from repro_torch.launch import netsim as launch  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--figure", action="append", choices=sorted(launch.FIGURES))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    out = {"full": args.full, "figures": {}}
    n = apart = 0
    for fig in args.figure or sorted(launch.FIGURES):
        t0 = time.perf_counter()
        jrows = getattr(figures, launch.FIGURES[fig].__name__)(full=args.full)
        jax_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = launch.main(["--figure", fig, "--profile-steps", "0"]
                          + (["--full"] if args.full else [])
                          + (["--device", args.device] if args.device else []))
        port_s = time.perf_counter() - t0
        rows = []
        for (name, _, pnote), (_, _, jnote) in zip(res["rows"], jrows):
            n += 1
            apart += pnote != jnote
            rows.append([name, pnote, jnote])
            print(f"{'!' if pnote != jnote else ' '} {name}: port {pnote} | jax {jnote}",
                  flush=True)
        print(f"{fig}: jax {jax_s:.1f} s, port {port_s:.1f} s on {res['device']}",
              flush=True)
        out["figures"][fig] = {"rows": rows, "jax_s": jax_s, "port_s": port_s,
                               "port_device": res["device"]}
    out.update(rows=n, rows_apart=apart)
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
