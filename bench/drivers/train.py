"""The ``train`` driver: a closed loop of AdamW steps through the port's
train step, as ``repro_torch.launch.train.train`` drives it.

Set-up builds one step object (``make_train_step``'s step on a 1 x 1 mesh,
the model holding the benchmark's weights, zero moments) and drives it
through the mix's ``checked_steps`` first steps, through the window's own
call and feed; those steps also warm up every shape the window uses. From
them it keeps each step's loss, each leaf's norm of the first step's
gradient as the optimizer got it (worked out from its first moment after one
step, m = (1 - beta1) g) and each leaf's norm of its change over the checked
steps. The window then continues the same object: each step takes a fresh
batch of B x (S + 1) token ids drawn from the seed on the device, runs the
step and reads its metrics on the host. After the window the program is
freed and the reference follows the checked steps from the same weights on
the same batches. A traced run then profiles ``traced_steps`` more steps
after the window (``bench.trace``), so that the window's timing carries no
profiler.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import statistics
import sys
import time
from typing import Dict, Optional

import torch

from bench import port
from bench import trace as tr
from bench.reference import common as ref
from bench.weights import family, make_weights, sub_seed
from bench.yardstick import compare

# faults a run can plant underneath the timed path (tests and control readings)
FAULTS = ("unchanged", "half_batch")


def batch_at(cfg: dict, mix: dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Step i's batch: B x (S + 1) uniform token ids, tokens and next-token labels."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "batch", i))
    ids = torch.randint(0, cfg["vocab_size"], (mix["batch"], mix["seq"] + 1), generator=gen,
                        device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


@contextlib.contextmanager
def _planted(fault: Optional[str]):
    """``unchanged``: the optimizer's update returns the state as it was."""
    if fault != "unchanged":
        yield
        return
    ts = importlib.import_module("repro_torch.train.train_step")
    from repro_torch.train.optimizer import AdamState
    real = ts.adam_update

    def unchanged(params, grads, state, cfg):
        return params, AdamState(step=state.step + 1, m=state.m, v=state.v), {
            "lr": torch.zeros(())}
    ts.adam_update = unchanged
    try:
        yield
    finally:
        ts.adam_update = real


class Program:
    """The step object and its state, built from the seed."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, fault: Optional[str] = None):
        from repro_torch.config.base import ParallelConfig, TrainConfig
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.train.train_step import make_train_step
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
        self.cfg, self.mix, self.seed, self.device, self.fault = cfg, mix, seed, device, fault
        self.start = make_weights(cfg, seed, device)
        self.model = port.build(cfg, self.start, device, remat=mix["remat"])
        par = ParallelConfig(multi_pod=False, data=1, model=1, remat=mix["remat"])
        train = TrainConfig(global_batch=mix["batch"], seq_len=mix["seq"], lr=mix["lr"],
                            warmup_steps=mix["warmup_steps"], total_steps=mix["total_steps"],
                            weight_decay=mix["weight_decay"], beta1=mix["beta1"],
                            beta2=mix["beta2"], eps=mix["eps"], grad_clip=mix["grad_clip"],
                            ckpt_every=0)
        _, _, jit_step, _ = make_train_step(self.model, par, train, make_mesh_for(par, device))
        self.step_fn = jit_step(dict(self.model.named_parameters()))
        self.params, self.opt = self.step_fn.place(dict(self.model.named_parameters()))
        self.steps = 0

    def step(self) -> dict:
        with tr.span("feed"):
            batch = batch_at(self.cfg, self.mix, self.seed, self.steps, self.device)
            if self.fault == "half_batch":
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        with tr.span("train_step"), _planted(self.fault):
            self.params, self.opt, metrics = self.step_fn(self.params, self.opt, batch)
        with tr.span("read_metrics"):
            row = {k: float(v) for k, v in metrics.items()}
        self.steps += 1
        return row

    def checked(self) -> dict:
        """The checked steps: each loss, the first gradient's and the change's
        norm of each leaf."""
        out: dict = {"loss": []}
        b1 = self.mix["beta1"]
        for i in range(self.mix["checked_steps"]):
            out["loss"].append(self.step()["loss"])
            if i == 0:
                with torch.no_grad():
                    out["grad"] = {k: float(m.to_local().float().norm()) / (1 - b1)
                                   for k, m in self.opt.m.items()}
        with torch.no_grad():
            out["change"] = {k: float((p.detach().float() - self.start[k].float()).norm())
                             for k, p in self.params.items()}
        self.start = None
        return out

    def free(self) -> None:
        self.model = self.step_fn = self.params = self.opt = self.start = None
        gc.collect()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference(cfg: dict, mix: dict, seed: int, device, prec: str = "f32") -> dict:
    """The reference's checked steps from the same weights and batches."""
    ref.no_tf32()
    stored = make_weights(cfg, seed, device)
    batches = [tuple(batch_at(cfg, mix, seed, i, device)[k] for k in ("tokens", "labels"))
               for i in range(mix["checked_steps"])]
    return ref.train_steps(family(cfg).block, cfg, stored, batches, mix, prec)


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device,
        fault: Optional[str] = None) -> dict:
    t_build = time.perf_counter()
    prog = Program(cfg, mix, seed, device, fault)
    t_steps = time.perf_counter()
    checked = prog.checked()
    print(f"setup: program built in {t_steps - t_build:.2f} s, {mix['checked_steps']} checked "
          f"steps in {time.perf_counter() - t_steps:.2f} s", file=sys.stderr)
    tokens = mix["batch"] * mix["seq"]
    first = prog.steps
    t0 = t1 = time.perf_counter()
    step_ms = []
    while True:
        prog.step()
        t1, last = time.perf_counter(), t1
        step_ms.append((t1 - last) * 1e3)
        if t1 - t0 >= seconds:
            break
    steps = prog.steps - first
    print(f"window: {steps} steps in {t1 - t0:.3f} s, step ms min {min(step_ms):.1f} median "
          f"{statistics.median(step_ms):.1f} max {max(step_ms):.1f}", file=sys.stderr)
    with tr.traced(traced) as holder:
        with tr.span("window"):
            for _ in range(mix["traced_steps"] if traced else 0):
                prog.step()
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    prog.free()
    t_ref = time.perf_counter()
    gaps = compare.train_gaps(checked, reference(cfg, mix, seed, device))
    print(f"reference: {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    return {"kind": "train", "window_start": t0, "window_s": t1 - t0, "attempted": steps,
            "failed": 0, "steps": steps, "tokens": steps * tokens, "memory_peak_bytes": peak,
            "trace": holder["trace"], "gaps": gaps, "losses": checked["loss"]}
