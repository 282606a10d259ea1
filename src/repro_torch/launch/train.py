"""Training entry point: AdamW steps on the synthetic Markov stream, on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train [--arch mamba2-370m] \
        [--smoke] [--steps N] [--batch B] [--seq S] [--lr LR] [--ckpt-dir DIR] \
        [--ckpt-every K] [--log-every K] [--data D] [--model M] [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --data 2 --model 2 ...

The port of ``repro.launch.train``: config -> model (random weights from the
train seed) -> a ``DeviceMesh`` of ``--data`` x ``--model`` ranks
(``launch.mesh.make_mesh_for``; without ``torchrun`` a world of one) -> the
train step of ``train_step.make_train_step`` on that mesh, the moments
placed by ``ShardingRules`` (on a 1 x 1 mesh no collective runs and the step
is the one-device step's arithmetic), the batch split over the data ranks
(loss, grad, clip, AdamW) in a checkpointed loop under ``FailureRecovery``,
with straggler monitoring. Every run takes that path, a 1 x 1 mesh included.
Its flags and defaults are the JAX launcher's, with these differences:
``--device`` is added (cuda by default, raising without a GPU; gloo process
groups on the CPU, NCCL on the card); the ``ParallelConfig`` defaults hold
(remat "block", one micro-batch); each step is logged
(``--log-every 1``); ``--ckpt-every 0`` turns checkpoints off; the
checkpoint directory defaults to ``build/ckpt/<arch>`` in the checkout; and
at full width the batch, sequence and steps default to the arch's workload
(``TRAIN_WORKLOADS``): qwen1.5-0.5b batch 8 x 2048 tokens, 5 steps;
mamba2-370m batch 4 x 2048, 3 steps; recurrentgemma-2b batch 1 x 4096 (two
windows of its local attention, so the band is real), 3 steps;
internlm2-1.8b, internvl2-2b and granite-moe-1b-a400m batch 4 x 2048 and
musicgen-large 4 x 1536 (30.7 s of EnCodec's 50 Hz frames: the loss runs in
chunks of 512, which 1500 does not divide, here as in the JAX package), 3
steps each, with no
checkpoints unless ``--ckpt-every`` asks (a full-width checkpoint with its
f32 moments runs to tens of GB, and a run that resumed from the workload's
last step would take none). With ``--smoke`` they default to the JAX
launcher's batch 8 x 256, 100 steps, a checkpoint every 50.
phi3.5-moe-42b-a6.6b, deepseek-67b and nemotron-4-340b train with
``--smoke`` only: at full width their weights, grads and moments do not fit
one card (their training waits for the distributed slice). A model of
embedding inputs (musicgen-large, internvl2-2b) trains on the dataset's
``embeds``; an MoE model's loss adds its aux losses, and each step logs the
MoE aux values (``lb_loss``, ``z_loss``, ``drop_frac``), each summed over the
MoE layers as the JAX backbone sums them.
After a failed step, training goes back to the latest checkpoint, parameters
and optimizer state included, and replays from there; with no checkpoint the
failure is raised, since the step updates its state in place. On a mesh of more
than one "model" rank (``--model M``) the step computes tensor-parallel:
each rank holds and updates only its shards of the parameters and moments
(``train_step``; with ``fsdp``, ZeRO-3 over "data" too), and the model is
put back whole when training ends. Checkpoints hold the parameters and the
moments gathered whole and are written by rank 0; only rank 0 logs.
A step is timed on the host clock around work that ends in a synchronise,
from the batch on the device to the metrics read; making the batch is timed
apart (``data_ms``). On the card each step also records
``peak_over_start_bytes``: the most bytes allocated during the step above
those allocated at its start (its parameters, optimizer state and batch are
allocated then), which the dry run predicts (``launch.dryrun``).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ParallelConfig, TrainConfig
from repro_torch.config.registry import get_model_config, list_archs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models.model import Model, build_model
from repro_torch.models.moe import AUX_KEYS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.elastic import FailureRecovery, StragglerMonitor
from repro_torch.train.optimizer import AdamState
from repro_torch.train.train_step import make_train_step


class Workload(NamedTuple):
    batch: int
    seq: int
    steps: int


# Each arch's default workload at full width, which launch.profile_train profiles.
TRAIN_WORKLOADS = {
    "qwen1.5-0.5b": Workload(batch=8, seq=2048, steps=5),
    "mamba2-370m": Workload(batch=4, seq=2048, steps=3),
    "recurrentgemma-2b": Workload(batch=1, seq=4096, steps=3),
    "internlm2-1.8b": Workload(batch=4, seq=2048, steps=3),
    "internvl2-2b": Workload(batch=4, seq=2048, steps=3),
    "granite-moe-1b-a400m": Workload(batch=4, seq=2048, steps=3),
    "musicgen-large": Workload(batch=4, seq=1536, steps=3),
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
          ckpt_every: Optional[int] = None, data: int = 1, model: int = 1
          ) -> Tuple[Model, TrainConfig, ParallelConfig]:
    """The model, train config and parallel config (a ``data`` x ``model``
    mesh) of a run; what is left ``None`` takes the arch's workload default
    (see the module docstring)."""
    if not smoke and arch not in TRAIN_WORKLOADS:
        raise ValueError(f"{arch} does not train on one card at full width (its "
                         f"training waits for the distributed slice); pass --smoke "
                         f"(full width: {sorted(TRAIN_WORKLOADS)})")
    work = SMOKE_WORKLOAD if smoke else TRAIN_WORKLOADS[arch]
    batch, seq, steps = (work.batch if batch is None else batch,
                         work.seq if seq is None else seq,
                         work.steps if steps is None else steps)
    if ckpt_every is None:
        ckpt_every = SMOKE_CKPT_EVERY if smoke else 0
    par = ParallelConfig(multi_pod=False, data=data, model=model)
    train_cfg = TrainConfig(
        global_batch=batch, seq_len=seq, lr=lr, total_steps=steps,
        warmup_steps=max(steps // 10, 1), ckpt_every=ckpt_every,
        ckpt_dir=ckpt_dir or str(CKPT_ROOT / (arch + ("-smoke" if smoke else ""))))
    net = build(arch, smoke=smoke, device=device, par=par, seed=train_cfg.seed)
    return net, train_cfg, par


def _full(tree: dict) -> dict:
    """Each DTensor of a name -> tensor dict gathered whole."""
    return {k: t.full_tensor() for k, t in tree.items()}


def _state(step_fn, params: dict, opt: AdamState) -> dict:
    """The checkpoint tree: the parameters and the moments, gathered whole."""
    return {"params": step_fn.full(params),
            "opt": {"step": opt.step, "m": _full(opt.m), "v": _full(opt.v)}}


def train(model: Model, train_cfg: TrainConfig, par: ParallelConfig = ParallelConfig(data=1, model=1),
          *, log_every: int = 1, log=print, mesh=None) -> TrainResult:
    """Runs ``train_cfg.total_steps`` steps through ``make_train_step`` on
    ``mesh`` (default: ``make_mesh_for(par)`` on the model's device),
    resuming from the latest checkpoint in ``train_cfg.ckpt_dir`` if there is
    one (none when ``ckpt_every`` is 0). The result holds the model with the
    final parameters and the final moments, gathered whole."""
    dev = model.device
    mesh = mesh if mesh is not None else make_mesh_for(par, dev)
    rank0 = dist.get_rank() == 0
    log = log if rank0 else (lambda line: None)
    _, _, jit_step, _ = make_train_step(model, par, train_cfg, mesh)
    params = dict(model.named_parameters())
    step_fn = jit_step(params)
    data = SyntheticDataset(model.cfg, train_cfg, device=dev)
    state = {}
    state["params"], state["opt"] = step_fn.place(params)    # zero moments, each its shard
    ckpt_dir = train_cfg.ckpt_dir or str(CKPT_ROOT / model.cfg.name)
    ckpt = (CheckpointManager(ckpt_dir, keep=train_cfg.ckpt_keep,
                              async_save=train_cfg.ckpt_async)
            if train_cfg.ckpt_every > 0 else None)
    monitor = StragglerMonitor()
    tokens = train_cfg.global_batch * train_cfg.seq_len
    res = TrainResult(model=model, opt_state=state["opt"], final_step=0, restarts=0,
                      tokens_per_step=tokens)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def save(step: int) -> None:
        tree = _state(step_fn, state["params"], state["opt"])   # collectives on every rank
        if rank0:
            ckpt.save(step, tree)

    def run(start: int) -> int:
        step = start
        while step < train_cfg.total_steps:
            t0 = time.perf_counter()
            batch = data.batch_at(step)
            sync()
            if dev.type == "cuda":
                start_bytes = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            state["params"], state["opt"], metrics = step_fn(state["params"], state["opt"],
                                                             batch)
            row = {k: float(v) for k, v in metrics.items()}
            sync()
            dt = time.perf_counter() - t1
            if dev.type == "cuda":
                row["peak_over_start_bytes"] = torch.cuda.max_memory_allocated(dev) - start_bytes
            verdict = monitor.observe(dt)
            step += 1
            row.update(step=step, ms=dt * 1e3, data_ms=(t1 - t0) * 1e3,
                       tokens_per_s=tokens / dt, verdict=verdict)
            res.history.append(row)
            if step % log_every == 0 or step == 1:
                moe = "".join(f" {k.removeprefix('moe_')} {row[k]:.4f}"
                              for k in AUX_KEYS if k in row)
                log(f"step {step:5d} loss {row['loss']:.4f} ce {row['ce']:.4f}{moe} "
                    f"gnorm {row['grad_norm']:.3f} lr {row['lr']:.2e} {row['ms']:.0f}ms "
                    f"({row['tokens_per_s']:.0f} tok/s)"
                    f"{' [' + verdict + ']' if verdict != 'ok' else ''}")
            if ckpt is not None and step % train_cfg.ckpt_every == 0:
                save(step)
        return step

    def restore(step: int) -> None:
        """Parameters and optimizer state from checkpoint ``step``."""
        ckpt.wait()
        like = _state(step_fn, state["params"], state["opt"])
        _, tree = ckpt.restore(step, like)
        o = tree["opt"]
        state["params"], state["opt"] = step_fn.place(
            tree["params"], AdamState(step=o["step"], m=o["m"], v=o["v"]))
        log(f"restored checkpoint step {step}")

    recovery = FailureRecovery(ckpt or _NoCheckpoints(), max_restarts=train_cfg.max_restarts,
                               restore=restore)
    start = ckpt.latest_step() if ckpt is not None else None
    if start is not None:
        restore(start)
    res.final_step = recovery.run(run, start or 0, train_cfg.total_steps)
    res.restarts = recovery.restarts
    if ckpt is not None:
        save(res.final_step)
        ckpt.wait()
    o = state["opt"]
    res.opt_state = AdamState(step=o.step, m=_full(o.m), v=_full(o.v))
    step_fn.unplace(state["params"])          # the model whole again
    log(f"done at step {res.final_step}")
    return res


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH, choices=list_archs())
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
    ap.add_argument("--data", type=int, default=1, help="data-parallel ranks of the mesh")
    ap.add_argument("--model", type=int, default=1, help="model-parallel ranks of the mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises when no GPU is visible")
    args = ap.parse_args(argv)
    model, train_cfg, par = setup(
        args.arch, smoke=args.smoke, device=args.device, batch=args.batch, seq=args.seq,
        steps=args.steps, lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        data=args.data, model=args.model)
    dev = model.device
    mesh = make_mesh_for(par, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if dist.get_rank() == 0:
        print(f"train {args.arch}{' (smoke)' if args.smoke else ''} on {name}: batch "
              f"{train_cfg.global_batch} x {train_cfg.seq_len} tokens, {train_cfg.total_steps} "
              f"steps, remat {par.remat}, mesh {dict(zip(par.axis_names(), par.mesh_shape()))}",
              flush=True)
    return train(model, train_cfg, par, log_every=args.log_every,
                 log=lambda line: print(line, flush=True), mesh=mesh)


if __name__ == "__main__":
    main()
