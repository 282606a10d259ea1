"""Runs one cell of the port's benchmark once, on the card it is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (``bench/harness.py``), makes
the weights and inputs from the seed, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with a trace ``breakdown``, and last
``compared``, each number that decided ``correct`` beside its limit (also
the last lines on standard error). Exits non-zero, printing no result, when
torch sees fewer cards than the cell asks for, when the program is not in
the checkout, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program (src/repro_torch) is not in {ROOT}", file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from bench import harness

    bm = harness.benchmark()
    chips = harness.cell(args.workload, bm)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, bm)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 4
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
