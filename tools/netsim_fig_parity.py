#!/usr/bin/env python3
"""The port's Fig. 3 rows against the JAX package's, at the paper's horizons.

    PYTHONPATH=src python tools/netsim_fig_parity.py [--figure fig3b] \
        [--full] [--device cpu] [--out rows.json] [--reference]

Runs ``benchmarks/figures.py``'s figure functions (JAX, on its default
backend) and ``repro_torch.launch.netsim``'s (on ``--device``, the GPU by
default) on the same grids and horizons, prints each row of both side by
side, marks the rows whose printed values differ, and ends with one JSON
line (the rows, the counts and both sides' wall seconds; also written to
``--out`` when given). Every figure by default. The CPU tests hold the same
rows at cut horizons (tests/test_torch_netsim_figures.py); this is the
uncut comparison, which takes tens of minutes on the CPU.

``--reference [JSON]`` also holds the port's rows against JAX's recorded
envelope (``torch_figure_reference.hold``): a file written by
``tests/torch_figure_reference.py`` for the same grids (``--reduced`` there
for the reduced ones: a cell's JAX row depends on the batch it runs in),
printing each row's reading and limit and ``inside`` or ``OUTSIDE``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]

from benchmarks import figures  # noqa: E402
from repro_torch.launch import netsim as launch  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--figure", action="append", choices=sorted(launch.FIGURES))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="")
    ap.add_argument("--reference", nargs="?", default=None, metavar="JSON",
                    const="tests/torch_figure_reference.json",
                    help="hold the port's rows against JAX's recorded envelope "
                         "(a file of tests/torch_figure_reference.py; --reduced "
                         "there for the reduced grids)")
    args = ap.parse_args(argv)
    if args.reference:
        import torch_figure_reference as ref
        doc = ref.load(Path(args.reference))
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
        if args.reference:
            held = ref.hold(res["values"], doc["figures"][fig])
            for name, fields in held["readings"].items():
                inside = all(r["dist"] <= r["limit"] for r in fields.values())
                print(f"  {'inside ' if inside else 'OUTSIDE'} {name}: " + ", ".join(
                    f"{f} {r['value']:.6g} in [{r['lo']:.6g}, {r['hi']:.6g}], "
                    f"{r['dist']:.4g} from JAX's base against {r['limit']:.4g}"
                    for f, r in fields.items()), flush=True)
            print("  " + ref.summary(fig, held), flush=True)
            out["figures"][fig]["held"] = {k: v for k, v in held.items() if k != "readings"}
    out.update(rows=n, rows_apart=apart)
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
