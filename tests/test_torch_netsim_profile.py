"""``launch.netsim.step_profile`` when the profiler hands back a trace with no
kernel in it (CUPTI can drop a whole trace while other processes use the
card): the trace is taken again, at most ``PROFILE_TRIES`` times, and what
every try left empty reads None, printed "not measured", never a crash.

The card is stood in for on the CPU: the profiler yields a scripted number of
empty traces and then ten fake kernels, the device synchronize is a no-op and
the CUDA graph replays nothing. No JAX is imported.
"""
import contextlib

import pytest
import torch
from torch.autograd import DeviceType

from repro_torch.config.net import NetConfig
from repro_torch.launch import netsim as launch


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Kernel:
    def __init__(self, i):
        self.device_type = DeviceType.CUDA
        self.name = f"k{i % 3}"
        self.time_range = _Range(2.0 * i, 2.0 * i + 1.0)


class _Graph:
    def replay(self):
        pass


def _profile_with(monkeypatch, n_empty: int) -> dict:
    traces = [0]

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            traces[0] += 1
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [] if traces[0] <= n_empty else [_Kernel(i) for i in range(10)]

    monkeypatch.setattr("torch.profiler.profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    return launch.step_profile([NetConfig(distance_km=10.0)],
                               launch.compare_workload(200.0), "dcqcn",
                               torch.device("cpu"), n_steps=2)


@pytest.mark.parametrize("n_empty", [0, 2])
def test_an_empty_trace_is_taken_again(monkeypatch, n_empty):
    r = _profile_with(monkeypatch, n_empty)
    assert r["empty_traces"] == n_empty
    assert r["kernels_per_step"] == 5.0
    assert r["graph_kernels_per_step"] == 10 / r["graph_steps"]
    # ten 1 us kernels, 2 us apart: 10 us busy over a 19 us span
    assert r["idle_share"] == pytest.approx(1 - 10 / 19)


def test_traces_empty_on_every_try_read_not_measured(monkeypatch):
    r = _profile_with(monkeypatch, 2 * launch.PROFILE_TRIES)
    assert r["empty_traces"] == 2 * launch.PROFILE_TRIES
    for k in ("kernels_per_step", "kernel_ms_per_step", "graph_kernels_per_step",
              "graph_kernel_ms_per_step", "graph_span_ms_per_step", "idle_share"):
        assert r[k] is None, k
    assert launch.fmt(r["idle_share"], ".1%") == "not measured"
    assert launch.fmt(0.644, ".1%") == "64.4%"
