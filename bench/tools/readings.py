"""The readings that a cell's limits are set from, at the cell's own sizes, in
one process: the program's gaps on many seeds, the control's (the reference
in fp8, in the program's place) and each fault's on a few.

    python3 bench/tools/readings.py --cell CELL --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults half_batch,...] [--fault-seeds 1,2,3] \
        [--seconds 2] --out build/readings.jsonl

Training reads the checked steps alone (no window). Serving runs a short
window of the cell's own load (``--seconds``) and checks as a run does; on a
control seed the run's checked batches are also read by the fp8 reference
(``control_gaps``).
Each reading is one JSON line of ``--out`` and a printed line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench.drivers import serve  # noqa: E402
from bench.reference import common as ref  # noqa: E402
from bench.weights import family, make_weights  # noqa: E402
from bench.yardstick import compare  # noqa: E402


def _ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def control_gaps(cfg: dict, mix: dict, seed: int, checked: list, device) -> dict:
    """The serving control: at each position of the checked batches' prompts
    and served tokens, the gap (in the float32 reference) of the token that
    the fp8 reference puts first."""
    ref.no_tf32()
    params = make_weights(cfg, seed, device)
    block, p = family(cfg).block, mix["prompt_len"]
    gaps = []
    for i, tokens in checked:
        seq = serve.fed(cfg, mix, seed, i, tokens, device)
        first = ref.served_logits(block, cfg, params, seq, p, "fp8").argmax(dim=-1)
        logits = ref.served_logits(block, cfg, params, seq, p)
        gaps.append(compare.logit_gaps(logits, first).flatten())
    g = torch.cat(gaps)
    return {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w = harness.cell(args.cell)
    cfg, mx = harness.config(w["config"]), harness.mix(w["traffic"])
    drv = harness.driver(mx["driver"])
    dev = torch.device(args.device)
    control, faults = _ints(args.control_seeds), [f for f in args.faults.split(",") if f]
    fault_seeds = _ints(args.fault_seeds)
    seeds = sorted(set(_ints(args.seeds)) | set(control) | set(fault_seeds))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(rec: dict) -> None:
        rec.update(cell=args.cell)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    for seed in seeds:
        t0 = time.perf_counter()
        if mx["driver"] == "train":
            progs = {None: None} if seed in _ints(args.seeds) else {}
            progs.update({f: None for f in faults if seed in fault_seeds})
            for fault in progs:
                p = drv.Program(cfg, mx, seed, dev, fault)
                progs[fault] = p.checked()
                p.free()
            if seed in control:
                progs["control"] = drv.reference(cfg, mx, seed, dev, "fp8")
            ref = drv.reference(cfg, mx, seed, dev)
            for what, got in progs.items():
                gaps = compare.train_gaps(got, ref)
                worst = {"worst_grad": compare.worst_leaf(got["grad"], ref["grad"]),
                         "worst_change": compare.worst_leaf(
                             got["change"], ref["change"], compare.moving_leaves(ref["grad_raw"]))}
                emit({"seed": seed, "what": what or "program", **gaps, **worst})
        else:
            rec = drv.run(cfg, mx, seed, args.seconds, False, dev)
            if seed in _ints(args.seeds):
                emit({"seed": seed, "what": "program", **rec["gaps"], "batches": rec["batches"]})
            if seed in control:
                emit({"seed": seed, "what": "control",
                      **control_gaps(cfg, mx, seed, rec["checked"], dev)})
            for fault in faults if seed in fault_seeds else ():
                got = drv.run(cfg, mx, seed, args.seconds, False, dev, fault=fault)["gaps"]
                emit({"seed": seed, "what": fault, "logit_gap": got["logit_gap"],
                      "mean_logit_gap": got["mean_logit_gap"]})
        print(f"seed {seed} took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
