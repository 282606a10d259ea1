"""Where serving time goes on the card, for one arch's default workload.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch mamba2-370m] [--trace-dir DIR]

The workload is the one ``python -m repro_torch.launch.serve --arch ARCH``
runs with no other arguments (``launch.serve.WORKLOADS``; qwen1.5-0.5b by
default: batch 4, prompt 512, 32 new tokens, cache of prompt + 32): its
prefill, and its greedy decode steps after the first token. Each phase runs
once unprofiled (host clock after a synchronise: wall time) and once under
``torch.profiler`` (kernel time by name, kernel count). Each decode run
starts from its own copy of the prefill's caches, as ``launch.serve``'s
decode starts from a fresh prefill: an SSD or RG-LRU state accumulates and a
local layer's ring is overwritten, so a second run from the same caches
would decode from another state. The device's
idle share is 1 - kernel time / wall time. Prints one JSON line. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.config.registry import ported_archs
from repro_torch.device import resolve_device
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.decode import greedy_decode


def measure(fn: Callable[[Any], Any], dev: torch.device, trace: Optional[Path] = None,
            setup: Callable[[], Any] = lambda: None, top: int = 12) -> dict:
    """Wall time of fn(setup()) unprofiled, then kernel time and count under the
    profiler; ``setup`` runs before each, outside the clock and the profile."""
    arg = setup()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn(arg)
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    arg = setup()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(arg)
        torch.cuda.synchronize(dev)
    if trace is not None:
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "wall_ms": wall_ms, "kernel_ms": busy_ms,
        "idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3}
                for e in kernels[:top]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=launch_serve.ARCH, choices=ported_archs())
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    work = launch_serve.WORKLOADS[args.arch]
    model = launch_serve.build(args.arch, device=dev)
    prompt = launch_serve.random_prompt(model, work.batch, work.prompt_len)
    s, steps = work.prompt_len, work.max_new - 1
    max_len = s + work.max_new
    launch_serve.serve(model, prompt, work.max_new)          # warm-up
    trace_dir = Path(args.trace_dir) if args.trace_dir else None

    prefill = measure(lambda _: model.prefill(prompt, max_len=max_len), dev,
                      trace_dir / "prefill.json" if trace_dir else None)
    caches, logits = model.prefill(prompt, max_len=max_len)
    token = torch.argmax(logits, dim=-1)

    def fresh_caches():
        return [{k: t.clone() for k, t in c.items()} for c in caches]

    decode = measure(lambda c: greedy_decode(model, c, token, s, steps), dev,
                     trace_dir / "decode.json" if trace_dir else None, setup=fresh_caches)
    decode["per_step_wall_ms"] = decode["wall_ms"] / steps
    decode["launches_per_step"] = decode["kernel_launches"] / steps
    out = {"arch": args.arch, "batch": work.batch, "prompt_len": s,
           "decode_steps": steps, "device": torch.cuda.get_device_name(dev),
           "prefill": prefill, "decode": decode}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
