"""The traced run: ``torch.profiler`` over the measured window, and what the
benchmark reads from its trace.

The trace is exported in Chrome's format to a file under ``TMPDIR``, read
and deleted. From it: the window (the benchmark's ``window`` span), every
device activity (kernels, copies, sets), each kernel's launch on the host
(by correlation id: its thread and time, and so the spans and ops around
the launch), and the host's spans and ops on each thread. A kernel belongs
to a span when the call that launched it lies inside the span, on the span's
thread: so an autograd Function's forward ("SSDScan") and its backward
("autograd::engine::evaluate_function: SSDScanBackward", on the autograd
thread) own the kernels they launch, and a CUDA graph's replay owns the
kernels of the graph.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
WINDOW = "window"
TOP = 10


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """What a Chrome trace of the window holds (times in microseconds)."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X"]
        wins = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not wins:
            raise ValueError("the trace holds no window span")
        w = wins[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main = (w.get("pid"), w.get("tid"))
        self.kernels = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""),
                         (e.get("args") or {}).get("correlation"))
                        for e in xs if e.get("cat") in DEVICE_CATS]
        self.launches: Dict[int, Tuple[tuple, float, str]] = {}
        self.host: Dict[tuple, List[Tuple[float, float, str, str]]] = defaultdict(list)
        for e in xs:
            cat = e.get("cat")
            if cat not in HOST_CATS:
                continue
            key, ts = (e.get("pid"), e.get("tid")), float(e["ts"])
            self.host[key].append((ts, ts + float(e["dur"]), e.get("name", ""), cat))
            corr = (e.get("args") or {}).get("correlation")
            if cat in LAUNCH_CATS and corr is not None:
                self.launches[corr] = (key, ts, e.get("name", ""))
        for spans in self.host.values():
            spans.sort(key=lambda s: (s[0], -s[1]))       # a parent before what it holds

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device activity inside the window."""
        return _union([(max(a, self.w0), min(b, self.w1)) for a, b, _, _ in self.kernels
                       if b > self.w0 and a < self.w1])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def count(self, name: str) -> int:
        """Host spans or ops of that name in the window."""
        return sum(1 for spans in self.host.values() for a, _, n, _ in spans
                   if n == name and self.w0 <= a <= self.w1)

    def device_s_under(self, names: Sequence[str]) -> float:
        """Device seconds of the activity launched inside any host span or op
        named in ``names``."""
        owned = {key: _union([(a, b) for a, b, n, _ in spans if n in names])
                 for key, spans in self.host.items()}
        starts = {key: [a for a, _ in iv] for key, iv in owned.items()}
        total = 0.0
        for a, b, _, corr in self.kernels:
            launch = self.launches.get(corr)
            if launch is None:
                continue
            key, ts, _ = launch
            iv = owned.get(key)
            if not iv:
                continue
            i = bisect.bisect_right(starts[key], ts) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                total += b - a
        return total / 1e6

    def graph_replays_s(self) -> List[float]:
        """Device seconds of each CUDA graph replay in the window: from its
        first kernel's start to its last kernel's end."""
        spans: Dict[int, List[float]] = {}
        for a, b, _, corr in self.kernels:
            launch = self.launches.get(corr)
            if launch is None or "GraphLaunch" not in launch[2]:
                continue
            if not self.w0 <= launch[1] <= self.w1:
                continue
            s = spans.setdefault(corr, [a, b])
            s[0], s[1] = min(s[0], a), max(s[1], b)
        return [(b - a) / 1e6 for a, b in spans.values()]

    def breakdown(self) -> dict:
        """The device activities that took most time, and the idle gaps
        summed by what the host's main thread was doing: the benchmark's
        innermost span, then the innermost op or call."""
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.kernels:
            if b > self.w0 and a < self.w1:
                by_name[name[:120]] += (b - a) / 1e6
        busy = self.busy()
        gaps, t = [], self.w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.w1:
            gaps.append((t, self.w1))
        idle: Dict[str, float] = defaultdict(float)
        for (a, b), name in zip(gaps, self._host_at([(a + b) / 2 for a, b in gaps])):
            idle[name] += (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}

    def _host_at(self, times: List[float]) -> List[str]:
        """For each time (ascending), the main thread's innermost span and op."""
        spans = self.host.get(self.main, [])
        out, stack, i = [], [], 0
        for t in times:
            while i < len(spans) and spans[i][0] <= t:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            span = next((n for _, _, n, c in reversed(stack) if c == "user_annotation"), "-")
            op = next((n for _, _, n, c in reversed(stack) if c != "user_annotation"), "")
            out.append(f"{span}/{op}" if op else span)
        return out


@contextlib.contextmanager
def traced(on: bool) -> Iterator[dict]:
    """With ``on``, profiles the block (CPU and, with a card, CUDA) and puts
    its ``Trace`` in the yielded dict under "trace"."""
    holder: dict = {"trace": None}
    if not on:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield holder
    t0 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    del prof
    holder["trace"] = Trace(events)
    print(f"trace: {len(events)} events, {size / 1e6:.1f} MB, export {t1 - t0:.1f} s, "
          f"read {time.perf_counter() - t1:.1f} s", file=sys.stderr)


def span(name: str):
    """A host span the traced run records (``record_function``)."""
    return torch.profiler.record_function(name)
