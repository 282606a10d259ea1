"""The port's step analysis (``launch.op_analysis``) against the JAX
package's HLO analysis (CPU): the ring model of collective bytes,
tests/test_hlo_analysis.py's synthetic module written as a torch program on
a fake (2, 16, 16) group, the scan of matmuls' FLOPs, the smoke qwen's mesh
step on a fake group against 8 gloo ranks, the live-byte count against
``MemTracker``, and the kernel ops' meta branch with ``kernels.cost``'s
formulas (which are also the bounds of PERF.md's kernel table).

Tolerances: all equal, except the peak of a CPU step against a meta one:
the CPU runs the flash op's plain version, whose own temporaries (which
the test measures) may raise the peak.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed._tools.mem_tracker import MemTracker

import torch_mesh_harness as harness
from repro.launch import hlo_analysis as jhlo
from repro_torch.config import ParallelConfig, TrainConfig, get_model_config
from repro_torch.kernels import cost, ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import op_analysis
from repro_torch.launch.op_analysis import Collective, record
from repro_torch.models import build_model
from repro_torch.train.optimizer import init_adam
from repro_torch.train.train_step import train_step
from test_hlo_analysis import SYNTHETIC

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("group", [1, 2, 16, 32, 256, 512])
def test_wire_bytes_match_jax(kind, group):
    for nbytes in (4, 256, 123_456_789):
        assert Collective(kind, group, nbytes).wire_bytes_per_device() == \
            jhlo.Collective(kind, group, nbytes).wire_bytes_per_device()


def test_synthetic_module_matches_jax(tmp_path):
    """The same program as SYNTHETIC's HLO, run on meta over a fake
    (2, 16, 16) group: every key of JAX's summary equal, both meshes."""
    got = harness.run_fake("synthetic", {}, tmp_path / "out.pt", shape=(2, 16, 16))
    for multi_pod in (True, False):
        want = jhlo.collective_summary(SYNTHETIC, multi_pod)
        assert got[multi_pod] == want, (multi_pod, got[multi_pod], want)


def test_scan_of_matmuls_flops_match_jax():
    """test_hlo_analysis.py's real compiled module: nine chained matmuls."""
    n, d, trips = 64, 32, 9

    @jax.jit
    def f(a, bs):
        out, _ = jax.lax.scan(lambda c, x: (c @ x, None), a, bs)
        return out

    txt = f.lower(jax.ShapeDtypeStruct((n, d), jnp.float32),
                  jax.ShapeDtypeStruct((trips, d, d), jnp.float32)).compile().as_text()
    _, jax_flops, _ = jhlo.aggregate(jhlo.parse_hlo_module(txt))
    a = torch.empty((n, d), device="meta")
    bs = torch.empty((trips, d, d), device="meta")
    with record() as rec:
        c = a
        for x in bs:
            c = c @ x
    assert rec.total_flops == jax_flops == trips * 2 * n * d * d


def test_fake_group_counts_equal_gloo_ranks(tmp_path):
    """The smoke qwen's mesh step on a fake (2, 2, 2) group on meta and on 8
    real gloo ranks on the CPU: the same collectives (kind, mesh dims, group,
    result bytes, count) and the same bytes. FLOPs differ by design (the CPU
    runs the flash op's plain version; meta counts the kernel's formula).
    The split step gathers no parameter: every collective is an all-reduce
    (the gradients over the batch dims, the activations over "model")."""
    args = {"cfg": get_model_config("qwen1.5-0.5b", smoke=True), "batch": (8, 64)}
    fake = harness.run_fake("record_step", dict(args, device="meta"), tmp_path / "fake.pt")
    real = harness.run_ranks("record_step", dict(args, device="cpu"), tmp_path / "real.pt")
    assert fake["collectives"] == real["collectives"]
    kinds = {c[0] for c in fake["collectives"]}
    assert kinds == {"all-reduce"}
    assert any(c[1] == ("model",) for c in fake["collectives"])
    for key in ("collective_bytes_per_device", "inter_pod_bytes_per_device",
                "intra_pod_bytes_per_device", "by_kind", "num_collectives"):
        assert fake["summary"][key] == real["summary"][key], key
    assert fake["summary"]["inter_pod_bytes_per_device"] > 0


def _step_peaks(dev: str):
    """(MemTracker's peak snapshot, the recorder's peak) of the one-device
    train step of the smoke qwen on ``dev``."""
    cfg = get_model_config("qwen1.5-0.5b", smoke=True)
    out = {}
    for which in ("memtracker", "recorder"):
        model = build_model(cfg, device=dev)
        params = dict(model.named_parameters())
        opt = init_adam({k: p.detach() for k, p in params.items()})
        tokens = torch.zeros((2, 256), dtype=torch.int64, device=dev)
        batch = {"tokens": tokens, "labels": tokens.clone()}
        track = (model, *opt.m.values(), *opt.v.values(), *batch.values())
        if which == "memtracker":
            mt = MemTracker()
            mt.track_external(*track)
            with mt:
                train_step(model, opt, batch, ParallelConfig(), TrainConfig())
            out[which] = {str(k): v for k, v in
                          mt.get_tracker_snapshot("peak")[torch.device(dev)].items()}
        else:
            with record(None, track) as rec:
                train_step(model, opt, batch, ParallelConfig(), TrainConfig())
            out[which] = rec.peak_bytes
    return out


def test_live_bytes_match_memtracker_meta_and_cpu():
    """The recorder's peak is MemTracker's, on meta and on the CPU; the
    parameter, gradient and optimizer bytes are equal on both devices; the
    peaks differ by no more than the plain flash version's own temporaries
    at that shape (the CPU runs attention_ref; on meta the op allocates its
    output alone)."""
    meta, cpu = _step_peaks("meta"), _step_peaks("cpu")
    for run in (meta, cpu):
        assert run["recorder"] == run["memtracker"]["Total"]
    for key in ("_MemRefType.PARAM", "_MemRefType.GRAD", "_MemRefType.OPT"):
        assert meta["memtracker"][key] == cpu["memtracker"][key], key
    cfg = get_model_config("qwen1.5-0.5b", smoke=True)
    q = torch.zeros((2, 256, cfg.num_heads, cfg.resolved_head_dim))
    k = torch.zeros((2, 256, cfg.num_kv_heads, cfg.resolved_head_dim))
    with record(None, (q, k)) as rec:
        o = attention_ref(q, k, k)
    plain_temps = rec.peak_bytes - 2 * q.numel() * 4 - o.numel() * o.element_size()
    assert 0 <= cpu["recorder"] - meta["recorder"] <= plain_temps


# ---------------------------------------------------------------------------
# The kernel ops' meta branch
# ---------------------------------------------------------------------------

def _flash(dev, window=0):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 64, 4, 16), generator=g).to(dev)
    kv = torch.randn((2, 64, 2, 16), generator=g).to(dev)
    return (lambda: ops.flash_attention(q, kv, kv, window=window),
            cost.attention_cost(2, 64, 4, 2, 16, 4, window))


def _ssd(dev):
    g = torch.Generator().manual_seed(0)
    x, dt = torch.randn((2, 96, 4, 8), generator=g), torch.rand((2, 96, 4), generator=g)
    A, B = -torch.rand(4, generator=g), torch.randn((2, 96, 1, 16), generator=g)
    args = [t.to(dev) for t in (x, dt, A, B, B)]
    return (lambda: ops.ssd_scan(*args, chunk=32), cost.ssd_cost(2, 96, 4, 8, 1, 16, 32, 4))


def _rglru(dev):
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand((2, 40, 8), generator=g).to(dev), torch.randn((2, 40, 8), generator=g).to(dev)
    return lambda: ops.rglru_recurrence(a, b), cost.rglru_cost(2, 40, 8, 4)


OPS = {"flash_attention": _flash, "flash_attention windowed": lambda d: _flash(d, window=16),
       "ssd_scan": _ssd, "rglru_scan": _rglru}


@pytest.mark.parametrize("op", list(OPS))
def test_meta_branch_shapes_and_cost(op):
    """On meta: the plain version's output shapes and dtypes, and the
    formula recorded once; a CPU tensor never reaches the branch."""
    seen = []
    with cost.recording(lambda *a: seen.append(a)):
        run_cpu, _ = OPS[op]("cpu")
        want = run_cpu()
        assert seen == []
        run_meta, formula = OPS[op]("meta")
        got = run_meta()
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    assert seen == [(op.split()[0], *formula)]


def test_meta_branch_records_into_the_recorder():
    run_meta, formula = _flash("meta")
    with record() as rec:
        run_meta()
    assert rec.kernel_ops == {"flash_attention": {"calls": 1, "flops": formula[0],
                                                  "bytes": formula[1]}}
    assert op_analysis.op_breakdown(rec)[0] == ("flash_attention", formula[1])


# PERF.md's kernel table: each bound as chip_smoke.py prints it, from the
# one copy of the formulas
BOUNDS = [
    (cost.attention_bound_ms, (4, 512, 16, 16, 64, 2), "0.0050 ms (bytes)"),
    (cost.attention_bound_ms, (4, 4096, 16, 16, 64, 2), "0.1390 ms (operations)"),
    (cost.attention_bound_ms, (4, 2048, 16, 8, 128, 2), "0.0695 ms (operations)"),
    (cost.attention_bound_ms, (1, 4096, 96, 8, 192, 2), "0.6255 ms (operations)"),
    (cost.attention_bound_ms, (4, 4096, 10, 1, 256, 2, 2048), "0.2606 ms (operations)"),
    (cost.ssd_bound_ms, (4, 2048, 32, 64, 1, 128, 128, 2), "0.0228 ms (bytes)"),
    (cost.rglru_bound_ms, (4, 4096, 2560, 4), "0.1502 ms (bytes)"),
]


@pytest.mark.parametrize("fn,args,printed", BOUNDS)
def test_bounds_are_perf_tables(fn, args, printed):
    ms, by = fn(*args)
    assert f"{ms:.4f} ms ({by})" == printed
