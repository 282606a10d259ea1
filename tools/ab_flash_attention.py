#!/usr/bin/env python3
"""Time the flash-attention kernel of several checkouts on one card, in turns.

    python3 tools/ab_flash_attention.py PARENT_DIR CHANGE_DIR [DIR ...]

Each DIR is the root of a checkout of the PyTorch port (for example a
commit's ``git archive`` unpacked under the git-ignored ``build/``). The
trees run in the order given, then in reverse (parent, change, change,
parent), each in a process of its own that builds the tree's kernel into the
tree's ``build/kernels`` and times ``flash_attention_fwd`` with CUDA events
after warm-up: causal at qwen1.5-0.5b's serving shapes (B=4, H=16, D=64,
bf16, S=512 and S=4096) and, where the tree's wrapper takes a window, at
recurrentgemma-2b's (B=4, S=4096, Hq=10, Hk=1, D=256, W=2048). Prints the
card's name and power limit, then one JSON line per run. Needs a GPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import inspect, json, sys
import torch
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_fwd

build.build(["flash_attention"])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)

def ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

def randn(*shape):
    return torch.randn(shape, generator=gen, device=dev).bfloat16()

out = {"tree": sys.argv[1]}
for s, iters in ((512, 50), (4096, 10)):
    q, k, v = randn(4, s, 16, 64), randn(4, s, 16, 64), randn(4, s, 16, 64)
    out[f"causal_s{s}_ms"] = ms(lambda: flash_attention_fwd(q, k, v), iters)
if "window" in inspect.signature(flash_attention_fwd).parameters:
    q, k, v = randn(4, 4096, 10, 256), randn(4, 4096, 1, 256), randn(4, 4096, 1, 256)
    out["windowed_d256_ms"] = ms(lambda: flash_attention_fwd(q, k, v, window=2048), 5)
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> None:
    trees = [Path(t).resolve() for t in (sys.argv[1:] if argv is None else argv)]
    if len(trees) < 2 or not all((t / "src" / "repro_torch").is_dir() for t in trees):
        sys.exit("usage: ab_flash_attention.py PARENT_DIR CHANGE_DIR [DIR ...] "
                 "(each the root of a checkout with src/repro_torch)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        run = subprocess.run([sys.executable, "-c", _CHILD, tree.name], env=env,
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            sys.exit(f"{tree}: exit {run.returncode}\n{run.stderr[-3000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
