"""Where serving time goes on the card, for one arch's default workload.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch mamba2-370m] [--trace-dir DIR]

The workload is the one ``python -m repro_torch.launch.serve --arch ARCH``
runs with no other arguments (``launch.serve.WORKLOADS``, at its depth;
qwen1.5-0.5b by default: batch 4, prompt 512, 32 new tokens, cache of
prompt + 32): its prefill, and its greedy decode steps after the first
token, through ``make_serve_step``'s captured CUDA graph (``decode``) and
through its eager step (``decode_eager``). Each phase runs once unprofiled
(host clock after a synchronise: wall time) and once under
``torch.profiler`` (kernel time by name, kernel count, the host's launch
calls). Each decode run starts from the prefill's caches (a copy for an
eager run; loaded into the graph's own caches for a graph run), as
``launch.serve``'s decode starts from a fresh prefill: an SSD or RG-LRU state
accumulates and a local layer's ring is overwritten, so a second run from
the same caches would decode from another state. The device's idle share is
1 - kernel time / wall time. Whole requests (``requests``, wall ms): the
first through a new step (prefill, the graph's capture, decode), a second
through the same step (prefill, the cache copy, decode), and prefill plus
the eager decode. Prints one JSON line. Needs a GPU.
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

from repro_torch.config.base import ParallelConfig
from repro_torch.config.registry import list_archs
from repro_torch.device import resolve_device
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.decode import greedy_decode, make_serve_step


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
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "wall_ms": wall_ms, "kernel_ms": busy_ms,
        "idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        # the host's launch calls (a kernel each, or a whole graph)
        "host_launches": sum(e.count for e in events if e.device_type == DeviceType.CPU
                             and e.key.startswith("cu") and "Launch" in e.key),
        "top": [{"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3}
                for e in kernels[:top]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=launch_serve.ARCH, choices=list_archs())
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    work = launch_serve.WORKLOADS[args.arch]
    model = launch_serve.build(args.arch, device=dev, layers=work.layers)
    prompt = launch_serve.random_prompt(model, work.batch, work.prompt_len)
    s, steps = work.prompt_len, work.max_new - 1
    max_len = s + work.max_new
    step, _, _ = make_serve_step(model, ParallelConfig(data=1, model=1), None, work.batch,
                                 max_len)
    first = launch_serve.serve(model, prompt, work.max_new, step=step)   # captures the step
    later = launch_serve.serve(model, prompt, work.max_new, step=step)
    trace_dir = Path(args.trace_dir) if args.trace_dir else None

    prefill = measure(lambda _: model.prefill(prompt, max_len=max_len), dev,
                      trace_dir / "prefill.json" if trace_dir else None)
    caches, logits = model.prefill(prompt, max_len=max_len)
    token = torch.argmax(logits, dim=-1)

    def fresh_caches():
        return [{k: t.clone() for k, t in c.items()} for c in caches]

    last = None if model.cfg.embed_inputs else prompt[:, -1:]
    eager = measure(lambda c: greedy_decode(model, c, token, s, steps, last, graph=False),
                    dev, trace_dir / "decode_eager.json" if trace_dir else None,
                    setup=fresh_caches)
    # the graph's caches are loaded with the prefill's before the clock
    inp = token if last is None else last
    graph = measure(lambda c: greedy_decode(model, c, token, s, steps, last, step=step),
                    dev, trace_dir / "decode.json" if trace_dir else None,
                    setup=lambda: step.load(fresh_caches(), inp))
    for d in (eager, graph):
        d["per_step_wall_ms"] = d["wall_ms"] / steps
        d["launches_per_step"] = d["kernel_launches"] / steps
        d["host_launches_per_step"] = d["host_launches"] / steps
    graph["capture_ms"] = first.load_ms
    requests = {"first_ms": first.request_ms, "capture_ms": first.load_ms,
                "later_ms": later.request_ms, "cache_copy_ms": later.load_ms,
                "eager_ms": prefill["wall_ms"] + eager["wall_ms"],
                "captures": step.captures}
    out = {"arch": args.arch, "layers": model.cfg.num_layers, "batch": work.batch,
           "prompt_len": s,
           "decode_steps": steps, "device": torch.cuda.get_device_name(dev),
           "prefill": prefill, "decode": graph, "decode_eager": eager, "requests": requests}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
