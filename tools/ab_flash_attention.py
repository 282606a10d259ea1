#!/usr/bin/env python3
"""Time one kernel of several checkouts on one card, in turns.

    python3 tools/ab_flash_attention.py [--kernel KERNEL] PARENT_DIR CHANGE_DIR [DIR ...]

Each DIR is the root of a checkout of the PyTorch port (for example a
commit's ``git archive`` unpacked under the git-ignored ``build/``). The
trees run in the order given, then in reverse (parent, change, change,
parent), each in a process of its own that builds the tree's kernel into the
tree's ``build/kernels`` and times its wrapper with CUDA events after
warm-up, at the serving shapes of the archs that run it. KERNEL is one of:

- ``flash_attention`` (the default): causal at qwen1.5-0.5b's shapes (B=4,
  H=16, D=64, bf16, S=512 and S=4096) and, where the tree's wrapper takes a
  window, at recurrentgemma-2b's (B=4, S=4096, Hq=10, Hk=1, D=256, W=2048);
- ``ssd_scan``: mamba2-370m's (b=4, s=2048, h=32, p=64, g=1, n=128,
  chunk 128), bf16 (the model's) and f32;
- ``rglru_scan``: recurrentgemma-2b's [4, 4096, 2560], f32 (the model's
  gates) and bf16.

Prints the card's name and power limit, then one JSON line per run. Needs a
GPU.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

_COMMON = r"""
import json, sys
import torch
from repro_torch.kernels import build

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
    return torch.randn(shape, generator=gen, device=dev)

out = {"tree": sys.argv[1]}
"""

_CHILDREN = {
    "flash_attention": r"""
import inspect
from repro_torch.kernels.flash_attention import flash_attention_fwd

build.build(["flash_attention"])
for s, iters in ((512, 50), (4096, 10)):
    q, k, v = (randn(4, s, 16, 64).bfloat16() for _ in range(3))
    out[f"causal_s{s}_ms"] = ms(lambda: flash_attention_fwd(q, k, v), iters)
if "window" in inspect.signature(flash_attention_fwd).parameters:
    q, k, v = (randn(4, 4096, h, 256).bfloat16() for h in (10, 1, 1))
    out["windowed_d256_ms"] = ms(lambda: flash_attention_fwd(q, k, v, window=2048), 5)
""",
    "ssd_scan": r"""
from repro_torch.kernels.ssd_scan import ssd_scan_fwd

build.build(["ssd_scan"])
b, s, h, p, g, n, chunk = 4, 2048, 32, 64, 1, 128, 128
for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    x = randn(b, s, h, p).to(dtype)
    dt, A = torch.nn.functional.softplus(randn(b, s, h)), -torch.exp(randn(h) * 0.5)
    B, C = ((randn(b, s, g, n) * 0.3).to(dtype) for _ in range(2))
    out[f"ssd_{name}_ms"] = ms(lambda: ssd_scan_fwd(x, dt, A, B, C, chunk=chunk), 20)
""",
    "rglru_scan": r"""
from repro_torch.kernels.rglru_scan import rglru_scan_fwd

build.build(["rglru_scan"])
for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    a = (torch.sigmoid(randn(4, 4096, 2560)) * 0.2 + 0.79).to(dtype)
    x = randn(4, 4096, 2560).to(dtype)
    out[f"rglru_{name}_ms"] = ms(lambda: rglru_scan_fwd(a, x), 20)
""",
}

def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(_CHILDREN), default="flash_attention")
    parser.add_argument("trees", nargs="+", metavar="DIR")
    args = parser.parse_args(argv)
    trees = [Path(t).resolve() for t in args.trees]
    if len(trees) < 2 or not all((t / "src" / "repro_torch").is_dir() for t in trees):
        sys.exit("usage: ab_flash_attention.py [--kernel KERNEL] PARENT_DIR CHANGE_DIR "
                 "[DIR ...] (each the root of a checkout with src/repro_torch)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    child = _COMMON + _CHILDREN[args.kernel] + "print(json.dumps(out), flush=True)\n"
    for tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        run = subprocess.run([sys.executable, "-c", child, tree.name], env=env,
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            sys.exit(f"{tree}: exit {run.returncode}\n{run.stderr[-3000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)

if __name__ == "__main__":
    main()
