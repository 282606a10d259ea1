"""Training entry point: AdamW steps on the synthetic Markov stream, one device.

    PYTHONPATH=src python -m repro_torch.launch.train [--arch mamba2-370m] \
        [--smoke] [--steps N] [--batch B] [--seq S] [--lr LR] [--ckpt-dir DIR] \
        [--ckpt-every K] [--log-every K] [--device cpu]

The port of ``repro.launch.train`` for one device: config -> model (random
weights from the train seed) -> train step (loss, grad, clip, AdamW) in a
checkpointed loop under ``FailureRecovery``, with straggler monitoring. Its
flags and defaults are the JAX launcher's, with these differences: the mesh
flags (``--data``, ``--model``) wait for the distributed slice; ``--device``
is added (cuda by default, raising without a GPU); the ``ParallelConfig``
defaults hold (remat "block", one micro-batch); each step is logged
(``--log-every 1``); ``--ckpt-every 0`` turns checkpoints off; the
checkpoint directory defaults to ``build/ckpt/<arch>`` in the checkout; and
at full width the batch, sequence and steps default to the arch's workload
(``TRAIN_WORKLOADS``): qwen1.5-0.5b batch 8 x 2048 tokens, 5 steps;
mamba2-370m batch 4 x 2048, 3 steps; recurrentgemma-2b batch 1 x 4096 (two
windows of its local attention, so the band is real), 3 steps, with no
checkpoints unless ``--ckpt-every`` asks (a full-width checkpoint with its
f32 moments runs to tens of GB, and a run that resumed from the workload's
last step would take none). With ``--smoke`` they default to the JAX
launcher's batch 8 x 256, 100 steps, a checkpoint every 50.
After a failed step, training goes back to the latest checkpoint, parameters
and optimizer state included, and replays from there; with no checkpoint the
failure is raised, since the step updates its state in place.
A step is timed on the host clock around work that ends in a synchronise,
from the batch on the device to the metrics read; making the batch is timed
apart (``data_ms``).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.base import ParallelConfig, TrainConfig
from repro_torch.config.registry import get_model_config, ported_archs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, build_model, check_ported
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.elastic import FailureRecovery, StragglerMonitor
from repro_torch.train.optimizer import AdamState, init_adam
from repro_torch.train.train_step import train_step


class Workload(NamedTuple):
    batch: int
    seq: int
    steps: int


# Each arch's default workload at full width, which launch.profile_train profiles.
TRAIN_WORKLOADS = {
    "qwen1.5-0.5b": Workload(batch=8, seq=2048, steps=5),
    "mamba2-370m": Workload(batch=4, seq=2048, steps=3),
    "recurrentgemma-2b": Workload(batch=1, seq=4096, steps=3),
}
SMOKE_WORKLOAD = Workload(batch=8, seq=256, steps=100)   # the JAX launcher's defaults
SMOKE_CKPT_EVERY = 50                                     # the JAX launcher's default
ARCH = "qwen1.5-0.5b"
CKPT_ROOT = Path(__file__).resolve().parents[3] / "build" / "ckpt"


@dataclass
class TrainResult:
    model: Model
    opt_state: AdamState
    final_step: int
    restarts: int
    tokens_per_step: int
    history: List[dict] = field(default_factory=list)   # one dict per step taken


class _NoCheckpoints:
    def latest_step(self) -> Optional[int]:
        return None


def build(arch: str, *, smoke: bool = False, device: DeviceLike = None,
          par: ParallelConfig = ParallelConfig(), seed: int = 0) -> Model:
    """The arch's model on ``device``, random weights from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build_model(get_model_config(arch, smoke=smoke), device=dev, generator=gen,
                       remat=par.remat)


def setup(arch: str, *, smoke: bool = False, device: DeviceLike = None,
          batch: Optional[int] = None, seq: Optional[int] = None,
          steps: Optional[int] = None, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: Optional[int] = None) -> Tuple[Model, TrainConfig, ParallelConfig]:
    """The model, train config and parallel config of a run; what is left
    ``None`` takes the arch's workload default (see the module docstring)."""
    check_ported(get_model_config(arch, smoke=smoke))
    work = SMOKE_WORKLOAD if smoke else TRAIN_WORKLOADS[arch]
    batch, seq, steps = (work.batch if batch is None else batch,
                         work.seq if seq is None else seq,
                         work.steps if steps is None else steps)
    if ckpt_every is None:
        ckpt_every = SMOKE_CKPT_EVERY if smoke else 0
    par = ParallelConfig()
    train_cfg = TrainConfig(
        global_batch=batch, seq_len=seq, lr=lr, total_steps=steps,
        warmup_steps=max(steps // 10, 1), ckpt_every=ckpt_every,
        ckpt_dir=ckpt_dir or str(CKPT_ROOT / (arch + ("-smoke" if smoke else ""))))
    model = build(arch, smoke=smoke, device=device, par=par, seed=train_cfg.seed)
    return model, train_cfg, par


def _state(model: Model, opt: AdamState) -> dict:
    return {"params": dict(model.named_parameters()),
            "opt": {"step": opt.step, "m": opt.m, "v": opt.v}}


def train(model: Model, train_cfg: TrainConfig, par: ParallelConfig = ParallelConfig(), *,
          log_every: int = 1, log=print) -> TrainResult:
    """Runs ``train_cfg.total_steps`` steps (resuming from the latest checkpoint
    in ``train_cfg.ckpt_dir`` if there is one; none when ``ckpt_every`` is 0)."""
    dev = model.embed.tok.device
    data = SyntheticDataset(model.cfg, train_cfg, device=dev)
    opt = init_adam(dict(model.named_parameters()), par.opt_state_dtype)
    ckpt_dir = train_cfg.ckpt_dir or str(CKPT_ROOT / model.cfg.name)
    ckpt = (CheckpointManager(ckpt_dir, keep=train_cfg.ckpt_keep,
                              async_save=train_cfg.ckpt_async)
            if train_cfg.ckpt_every > 0 else None)
    monitor = StragglerMonitor()
    tokens = train_cfg.global_batch * train_cfg.seq_len
    res = TrainResult(model=model, opt_state=opt, final_step=0, restarts=0,
                      tokens_per_step=tokens)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(start: int) -> int:
        step = start
        while step < train_cfg.total_steps:
            t0 = time.perf_counter()
            batch = data.batch_at(step)
            sync()
            t1 = time.perf_counter()
            res.opt_state, metrics = train_step(model, res.opt_state, batch, par, train_cfg)
            row = {k: float(v) for k, v in metrics.items()}
            sync()
            dt = time.perf_counter() - t1
            verdict = monitor.observe(dt)
            step += 1
            row.update(step=step, ms=dt * 1e3, data_ms=(t1 - t0) * 1e3,
                       tokens_per_s=tokens / dt, verdict=verdict)
            res.history.append(row)
            if step % log_every == 0 or step == 1:
                log(f"step {step:5d} loss {row['loss']:.4f} ce {row['ce']:.4f} "
                    f"gnorm {row['grad_norm']:.3f} lr {row['lr']:.2e} {row['ms']:.0f}ms "
                    f"({row['tokens_per_s']:.0f} tok/s)"
                    f"{' [' + verdict + ']' if verdict != 'ok' else ''}")
            if ckpt is not None and step % train_cfg.ckpt_every == 0:
                ckpt.save(step, _state(model, res.opt_state))
        return step

    def restore(step: int) -> None:
        """Parameters and optimizer state from checkpoint ``step``."""
        ckpt.wait()
        _, state = ckpt.restore(step, _state(model, res.opt_state))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state["params"][name])
        o = state["opt"]
        res.opt_state = AdamState(step=o["step"], m=o["m"], v=o["v"])
        log(f"restored checkpoint step {step}")

    recovery = FailureRecovery(ckpt or _NoCheckpoints(), max_restarts=train_cfg.max_restarts,
                               restore=restore)
    start = ckpt.latest_step() if ckpt is not None else None
    if start is not None:
        restore(start)
    res.final_step = recovery.run(run, start or 0, train_cfg.total_steps)
    res.restarts = recovery.restarts
    if ckpt is not None:
        ckpt.save(res.final_step, _state(model, res.opt_state))
        ckpt.wait()
    log(f"done at step {res.final_step}")
    return res


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH, choices=ported_archs())
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--steps", type=int, help="default: the arch's workload")
    ap.add_argument("--batch", type=int, help="default: the arch's workload")
    ap.add_argument("--seq", type=int, help="default: the arch's workload")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", help="default: build/ckpt/<arch> in the checkout")
    ap.add_argument("--ckpt-every", type=int,
                    help=f"0: no checkpoints (default: 0 at full width, {SMOKE_CKPT_EVERY} "
                         "with --smoke)")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises when no GPU is visible")
    args = ap.parse_args(argv)
    model, train_cfg, par = setup(
        args.arch, smoke=args.smoke, device=args.device, batch=args.batch, seq=args.seq,
        steps=args.steps, lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    dev = model.embed.tok.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"train {args.arch}{' (smoke)' if args.smoke else ''} on {name}: batch "
          f"{train_cfg.global_batch} x {train_cfg.seq_len} tokens, {train_cfg.total_steps} "
          f"steps, remat {par.remat}", flush=True)
    return train(model, train_cfg, par, log_every=args.log_every,
                 log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
