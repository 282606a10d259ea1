"""Where serving time goes on the card, for ``launch.serve``'s default workload.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--trace-dir DIR]

The workload is the one ``python -m repro_torch.launch.serve`` runs with no
arguments (qwen1.5-0.5b, batch 4, prompt 512, 32 new tokens, cache of
prompt + 32): its prefill, and its 31 greedy decode steps after the first
token. Each phase runs once unprofiled (host clock after a synchronise: wall time)
and once under ``torch.profiler`` (kernel time by name, kernel count). The
device's idle share is 1 - kernel time / wall time. Prints one JSON line.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.device import resolve_device
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.decode import greedy_decode


def measure(fn, dev: torch.device, trace: Path = None, top: int = 12) -> dict:
    """Wall time of fn() unprofiled, then kernel time and count under the profiler."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    model = launch_serve.build(launch_serve.ARCH, device=dev)
    prompt = launch_serve.random_prompt(model, launch_serve.BATCH, launch_serve.PROMPT_LEN)
    s, max_new = launch_serve.PROMPT_LEN, launch_serve.MAX_NEW
    steps = max_new - 1
    launch_serve.serve(model, prompt, max_new)               # warm-up
    trace_dir = Path(args.trace_dir) if args.trace_dir else None

    prefill = measure(lambda: model.prefill(prompt, max_len=s + max_new), dev,
                      trace_dir / "prefill.json" if trace_dir else None)
    caches, logits = model.prefill(prompt, max_len=s + max_new)
    token = torch.argmax(logits, dim=-1)
    # Each run decodes from the end of the prompt, so both rewrite the same
    # cache rows, as launch.serve's decode does.
    decode = measure(lambda: greedy_decode(model, caches, token, s, steps), dev,
                     trace_dir / "decode.json" if trace_dir else None)
    decode["per_step_wall_ms"] = decode["wall_ms"] / steps
    decode["launches_per_step"] = decode["kernel_launches"] / steps
    out = {"arch": launch_serve.ARCH, "batch": launch_serve.BATCH, "prompt_len": s,
           "decode_steps": steps, "device": torch.cuda.get_device_name(dev),
           "prefill": prefill, "decode": decode}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
