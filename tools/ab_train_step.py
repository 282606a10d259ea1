#!/usr/bin/env python3
"""Time ``launch.train``'s steps of several checkouts on one card, in turns.

    python3 tools/ab_train_step.py [--archs A,B,...] [--steps N] PARENT_DIR CHANGE_DIR [DIR ...]
    python3 tools/ab_train_step.py --mesh-vs-plain [--archs A,B,...] [--steps N] DIR

Each DIR is the root of a checkout of the PyTorch port (for example a
commit's ``git archive`` unpacked under the git-ignored ``build/``). The
trees run in the order given, then in reverse (parent, change, change,
parent), each in a process of its own that runs ``python -m
repro_torch.launch.train --arch ARCH --ckpt-every 0`` in-process for every
arch (default: qwen1.5-0.5b, mamba2-370m, recurrentgemma-2b), at the arch's
default full-width workload, and reads each step's ms (host clock around
the step, after a synchronise) and loss from its result. The first step of
a run holds its warm-up; compare the later ones. ``--steps`` sets the
number of steps (default: the workload's).

With ``--mesh-vs-plain`` one process in DIR builds each arch twice from
one seed and alternates, step by step, ``make_train_step``'s step on a
1 x 1 mesh (what ``launch.train`` runs) and the plain ``train_step``, on the
same batches: the two step times side by side in one process, whose host
state (the process group, the allocator) both share.

Prints the card's name and power limit, then one JSON line per run. Needs a
GPU.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ARCHS = "qwen1.5-0.5b,mamba2-370m,recurrentgemma-2b"

_CHILD = r"""
import contextlib, io, json, sys
import torch
from repro_torch.launch import train as launch_train

for arch in sys.argv[2].split(","):
    steps = ["--steps", sys.argv[3]] if sys.argv[3] != "0" else []
    with contextlib.redirect_stdout(io.StringIO()):
        res = launch_train.main(["--arch", arch, "--ckpt-every", "0", "--log-every", "1000"]
                                + steps)
    print(json.dumps({"tree": sys.argv[1], "arch": arch,
                      "ms": [round(r["ms"], 2) for r in res.history],
                      "loss": [r["loss"] for r in res.history],
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
"""


_MESH_VS_PLAIN = r"""
import json, sys, time
import torch
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.train import SyntheticDataset, init_adam, train_step
from repro_torch.train.train_step import make_train_step

dev = torch.device("cuda", 0)
for arch in sys.argv[2].split(","):
    steps = int(sys.argv[3]) or None
    runs = {}
    for how in ("mesh", "plain"):
        model, cfg, par = launch_train.setup(arch, device=dev, steps=steps)
        opt = init_adam(dict(model.named_parameters()), par.opt_state_dtype)
        if how == "mesh":
            _, _, jit_step, _ = make_train_step(model, par, cfg, make_mesh_for(par, dev))
            sstep = jit_step(dict(model.named_parameters()))
            params, opt = sstep.place(dict(model.named_parameters()), opt)
            runs[how] = [model, cfg, par, opt, (sstep, params)]
        else:
            runs[how] = [model, cfg, par, opt, None]
    data = SyntheticDataset(runs["plain"][0].cfg, runs["plain"][1], device=dev)
    ms = {"mesh": [], "plain": []}
    loss = {"mesh": [], "plain": []}
    for i in range(runs["plain"][1].total_steps):
        batch = data.batch_at(i)
        for how in ("mesh", "plain") if i % 2 == 0 else ("plain", "mesh"):
            model, cfg, par, opt, mesh = runs[how]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mesh:
                _, opt, m = mesh[0](mesh[1], opt, batch)
            else:
                opt, m = train_step(model, opt, batch, par, cfg)
            loss[how].append(float(m["loss"]))
            torch.cuda.synchronize()
            ms[how].append(round((time.perf_counter() - t0) * 1e3, 2))
            runs[how][3] = opt
    print(json.dumps({"tree": sys.argv[1], "arch": arch, "ms": ms, "loss": loss}), flush=True)
    del runs, data
    torch.cuda.empty_cache()
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--archs", default=ARCHS)
    ap.add_argument("--steps", type=int, default=0, help="0: the workload's")
    ap.add_argument("--mesh-vs-plain", action="store_true")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    order = list(args.dirs) + list(reversed(args.dirs))
    if args.mesh_vs_plain:
        order = args.dirs[:1]
    for d in order:
        root = Path(d).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        child = _MESH_VS_PLAIN if args.mesh_vs_plain else _CHILD
        r = subprocess.run([sys.executable, "-c", child, str(d), args.archs, str(args.steps)],
                           cwd=root,
                           env=env, capture_output=True, text=True, timeout=1200)
        sys.stdout.write(r.stdout)
        if r.returncode:
            sys.stdout.write(r.stderr[-4000:])
            raise SystemExit(f"{d}: exit {r.returncode}")


if __name__ == "__main__":
    main()
