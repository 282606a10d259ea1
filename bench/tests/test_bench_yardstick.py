"""The yardstick's frozen arithmetic, tied to today's program without the
harness reading the program at run time."""
import pytest

from bench import harness
from bench.trace import Trace
from bench.yardstick import cost, params, stats


# PERF.md's kernel table: flash B=4 H=16 D=64 bf16 at S=512 and S=4096, GQA
# 16:8 D=128 S=2048, 96:8 D=192 S=4096 (B=1), windowed D=256; the SSD at the
# serving shape
FLASH = [(4, 512, 16, 16, 64, 2, 0), (4, 4096, 16, 16, 64, 2, 0), (4, 2048, 16, 8, 128, 2, 0),
         (1, 4096, 96, 8, 192, 2, 0), (1, 4096, 10, 1, 256, 2, 2048), (4, 2048, 16, 8, 64, 2, 0)]
SSD = [(4, 2048, 32, 64, 1, 128, 128, 2), (4, 2048, 32, 64, 1, 128, 128, 4)]


@pytest.mark.parametrize("shape", FLASH)
def test_attention_forward_is_the_programs(shape):
    from repro_torch.kernels import cost as program
    assert cost.attention_cost(*shape) == program.attention_cost(*shape)
    flops, nbytes = cost.attention_bwd_cost(*shape)
    assert flops == 2 * program.attention_cost(*shape)[0] and nbytes > 0


@pytest.mark.parametrize("shape", SSD)
def test_ssd_forward_is_the_programs(shape):
    from repro_torch.kernels import cost as program
    assert cost.ssd_cost(*shape) == program.ssd_cost(*shape)
    assert cost.ssd_bwd_cost(*shape)[0] == 2 * program.ssd_cost(*shape)[0]


def test_peaks_are_the_programs():
    from repro_torch.kernels import cost as program
    assert (cost.PEAK_FLOPS_BF16, cost.PEAK_FLOPS_F32, cost.PEAK_BYTES) == (
        program.PEAK_FLOPS_BF16, program.PEAK_FLOPS_F32, program.PEAK_BYTES)


@pytest.mark.parametrize("name", [c["name"] for c in harness.benchmark()["configs"]])
def test_parameter_counts_are_the_models(name):
    from bench import port
    from repro_torch.models.model import Model
    cfg = harness.config(name)
    model = Model(port.model_config(cfg), device="meta")
    assert params.param_count(cfg) == sum(p.numel() for p in model.parameters())
    assert params.active_param_count(cfg) == model.active_param_count()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = harness.driver("train").family(cfg).param_specs(cfg)
    assert shapes == {n: tuple(s) for n, s, *_ in specs}


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reading():
    """Busy share as a union, kernels owned by the span that launched them
    (on its own thread), graph replays, idle gaps by the host's activity."""
    ev = [_x("window", "user_annotation", 0, 1000),
          _x("train_step", "user_annotation", 0, 600),
          _x("SSDScan", "cpu_op", 10, 50),
          _x("cudaLaunchKernel", "cuda_runtime", 20, 5, corr=1),
          _x("autograd::engine::evaluate_function: SSDScanBackward", "cpu_op", 100, 100, tid=2),
          _x("cudaLaunchKernel", "cuda_runtime", 150, 5, tid=2, corr=2),
          _x("cudaLaunchKernel", "cuda_runtime", 300, 5, corr=3),
          _x("request", "user_annotation", 700, 250),
          _x("cudaGraphLaunch", "cuda_runtime", 710, 5, corr=4),
          _x("k1", "kernel", 30, 100, tid=7, corr=1),
          _x("k2", "kernel", 100, 100, tid=7, corr=2),      # overlaps k1: union 30-200
          _x("k3", "kernel", 400, 100, tid=7, corr=3),
          _x("g1", "kernel", 720, 30, tid=7, corr=4),
          _x("g2", "kernel", 760, 40, tid=7, corr=4)]
    t = Trace(ev)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((170 + 100 + 80) * 1e-6 - 10e-6)
    assert t.device_s_under(("SSDScan", "autograd::engine::evaluate_function: SSDScanBackward")) \
        == pytest.approx(200e-6)
    assert t.count("autograd::engine::evaluate_function: SSDScanBackward") == 1
    assert t.graph_replays_s() == [pytest.approx(80e-6)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(100e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"train_step/SSDScan": pytest.approx(30e-6),
                    "train_step/cudaLaunchKernel": pytest.approx(200e-6),
                    "window": pytest.approx(220e-6), "request": pytest.approx(210e-6)}


@pytest.mark.parametrize("kind,count", [("train", "traced_steps"), ("serve", "traced_batches")])
def test_idle_share_reads_the_untraced_step(kind, count):
    """Busy time per traced step over the untraced window's time per step:
    the traced window, stretched by the profiler, is not the denominator."""
    from types import SimpleNamespace
    t = Trace([_x("window", "user_annotation", 0, 10_000), _x("k", "kernel", 100, 340, tid=7)])
    run = SimpleNamespace(kind=kind, trace=t, mix={count: 1}, window_s=4e-3, steps=10,
                          batches=10)
    assert harness.metric(f"idle_share.{kind}").read(run) == pytest.approx(15.0)
    other = "serve" if kind == "train" else "train"
    assert harness.metric(f"idle_share.{other}").read(run) is None

def test_stats():
    assert stats.percentile([float(i) for i in range(1, 101)], 95) == pytest.approx(95.05)
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
