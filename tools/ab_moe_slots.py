#!/usr/bin/env python3
"""Time the MoE slot positions on one card, two layouts in turns.

    python3 tools/ab_moe_slots.py [--slots 65536] [--experts 32] [--iters 20]

The position of each slot of the flat token-major expert ids in its expert
(an exclusive cumsum of the one-hot) computed two ways on the same ids: as
the JAX package's ``_moe_tokens`` lays it out, a [T*k, E] one-hot scanned
along its first dim, and as ``repro_torch.models.moe.slots`` does, an
[E, T*k] one-hot scanned along its contiguous last dim. The two must give
equal positions. The defaults are granite-moe-1b-a400m's prefill at
launch.serve's workload (T = 4 * 2048 tokens, k = 8, E = 32; capacity
1.25 * T * k / E). Runs in the order outer, inner, inner, outer, each the
mean device time of ``--iters`` calls after warm-up (CUDA events). Prints
the card's name and power limit, then one JSON line. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.models import moe  # noqa: E402


def outer(flat_e: torch.Tensor, e: int, cap: int):
    """The positions from a [T*k, E] one-hot scanned along its first dim."""
    onehot = F.one_hot(flat_e, e).to(torch.int32)
    before = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = torch.gather(before, 1, flat_e[:, None])[:, 0]
    return pos, pos < cap


def device_ms(fn, *args, iters: int) -> float:
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=4 * 2048 * 8, help="T * k")
    ap.add_argument("--experts", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_moe_slots: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    e, cap = args.experts, int(1.25 * args.slots / args.experts)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat_e = torch.randint(0, e, (args.slots,), generator=gen, device="cuda")
    ref, got = outer(flat_e, e, cap), moe.slots(flat_e, e, cap)
    if not all(torch.equal(a, b) for a, b in zip(ref, got)):
        sys.exit("ab_moe_slots: the two layouts give other positions")
    runs = [(name, device_ms(fn, flat_e, e, cap, iters=args.iters))
            for name, fn in (("outer", outer), ("inner", moe.slots),
                             ("inner", moe.slots), ("outer", outer))]
    out = {"device": torch.cuda.get_device_name(0), "slots": args.slots, "experts": e,
           "runs_ms": runs}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
