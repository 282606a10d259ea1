"""The port against the plain reference at small sizes on the CPU, under the
limits on each cell's numbers at that size (``small.limits``): a sound run
is correct, and a run with its timed path broken underneath is not. The faults of a run (``drivers.*.FAULTS``) are
planted by the driver; the program's faults here are planted in
``repro_torch`` itself, and the control is the reference in fp8 put in the
program's place."""
import contextlib
import importlib

import pytest
import torch

from bench import harness
from bench.drivers import serve, train
from bench.tests import small
from bench.tools.readings import control_gaps
from bench.yardstick import compare

BM = harness.benchmark()
TRAIN = [w["name"] for w in BM["workloads"] if harness.mix(w["traffic"])["driver"] == "train"]
SERVE = [w["name"] for w in BM["workloads"] if harness.mix(w["traffic"])["driver"] == "serve"]
SSM_TRAIN = next(c for c in TRAIN if harness.cell(c)["config"] == "mamba2-370m")
MOE_TRAIN = next(c for c in TRAIN if harness.cell(c)["config"] == "granite-moe-1b-a400m")


@contextlib.contextmanager
def planted(module: str, name: str, new):
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    setattr(mod, name, new(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def _readings(out: dict) -> dict:
    return {k: v["value"] for k, v in out["compared"].items()}


def test_small_limits_compare_what_the_cells_compare():
    for c in TRAIN + SERVE:
        assert set(small.limits(c)) == set(harness.limits(c)), c


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    out = small.run(cell)
    assert out["correct"], _readings(out)
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN for f in train.FAULTS]
                         + [(c, f) for c in SERVE for f in serve.FAULTS])
def test_run_with_a_fault_is_not_correct(cell, fault):
    """A step that returns its state unchanged, half the batch left out, a
    served token altered where it is made, decode steps that leave the
    caches as they were."""
    out = small.run(cell, fault=fault)
    assert not out["correct"], _readings(out)


def _no_carry(real):
    """The SSD scan with its state not carried from one chunk to the next."""
    def scan(x, dt, A, B, C, *, chunk, init_state=None, round_to=None):
        c = min(chunk, x.shape[1])
        parts = [real(x[:, a:a + c], dt[:, a:a + c], A, B[:, a:a + c], C[:, a:a + c],
                      chunk=c, round_to=round_to) for a in range(0, x.shape[1], c)]
        return torch.cat([y for y, _ in parts], dim=1), parts[-1][1]
    return scan


def _f32_leaves_in_bf16(real):
    """AdamW that leaves each float32 parameter rounded to bf16."""
    def update(params, grads, state, cfg):
        out = real(params, grads, state, cfg)
        with torch.no_grad():
            for p in params.values():
                if p.dtype == torch.float32:
                    p.copy_(p.bfloat16().float())
        return out
    return update


def _half_capacity(real):
    """Each expert's capacity halved: the slots past half of it dropped."""
    return lambda cfg, tokens: real(cfg, tokens) // 2


@pytest.mark.parametrize("cell,module,name,fault", [
    (SSM_TRAIN, "repro_torch.models.ssm", "ssd_chunked", _no_carry),
    (SSM_TRAIN, "repro_torch.train.train_step", "adam_update", _f32_leaves_in_bf16),
    (MOE_TRAIN, "repro_torch.models.moe", "capacity", _half_capacity),
], ids=["ssd_state_not_carried", "f32_leaves_in_bf16", "moe_capacity_slots_dropped"])
def test_program_fault_is_not_correct(cell, module, name, fault):
    with planted(module, name, fault):
        out = small.run(cell)
    assert not out["correct"], _readings(out)


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_is_not_correct(cell):
    """The reference in fp8 in the program's place, against the limits."""
    w = harness.cell(cell)
    cfg, mx = small.config(w["config"]), small.mix(w["traffic"])
    gaps = compare.train_gaps(train.reference(cfg, mx, small.SEED, "cpu", "fp8"),
                              train.reference(cfg, mx, small.SEED, "cpu"))
    lim = small.limits(cell)
    assert any(gaps[k] > lim[k] for k in lim), gaps


@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_is_not_correct(cell):
    """The tokens the fp8 reference puts first, read by the float32 reference."""
    w = harness.cell(cell)
    mx = dict(small.mix(w["traffic"]), checked_batches=4)
    cfg = small.config(w["config"])
    rec = serve.run(cfg, mx, small.SEED, 0.05, False, "cpu")
    gaps = control_gaps(cfg, mx, small.SEED, rec["checked"], "cpu")
    assert any(gaps[k] > v for k, v in small.limits(cell).items()), gaps
