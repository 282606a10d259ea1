"""AdamW and the LR schedule: the port of ``repro.train.optimizer``.

The arithmetic is the JAX package's, step for step: maths in f32, the
parameters and the moments cast back to their storage dtypes, the weight
decay decoupled and scaled by the learning rate, the bias correction from
the step. It is not ``torch.optim.AdamW``, whose order of operations and
rounding differ. The optimizer state mirrors the parameters (m and v per
leaf, keyed by parameter name); ``opt_state_dtype`` may keep m and v in bf16.
``adam_update`` writes the new parameters and moments into the given
tensors in place, where the JAX package returns new arrays (on the card a
second copy of recurrentgemma-2b's f32 moments would not fit beside the
first).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.device import dtype_of

Tree = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the CPU
    m: Tree
    v: Tree


def init_adam(params: Tree, dtype: str = "float32") -> AdamState:
    dt = dtype_of(dtype)
    zeros = {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()}
    return AdamState(step=torch.zeros((), dtype=torch.int32),
                     m=zeros, v={k: torch.zeros_like(z) for k, z in zeros.items()})


def _f32(x: Union[int, float, torch.Tensor]) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def lr_schedule(cfg: TrainConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, in f32 (a CPU scalar)."""
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(_f32(math.pi) * prog))
    return _f32(cfg.lr) * warm * cos


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (on the leaves' device)."""
    sq = sum(torch.sum(torch.square(g.float())) for g in tree.values())
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Tree, max_norm: float, norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled to at most ``max_norm``, the norm): ``norm`` the global
    norm when ``grads`` are shards of a larger tree, else theirs."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adam_update(params: Tree, grads: Tree, state: AdamState, cfg: TrainConfig
                ) -> Tuple[Tree, AdamState, dict]:
    """Returns (params, new_state, metrics ``lr``). The parameters and the
    moments are updated in place, one leaf at a time, so that no second copy
    of the optimizer state exists and a leaf's f32 temporaries are freed
    before the next; each in-place operation rounds as the JAX expression
    it stands for."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    corr1 = float(1.0 - _f32(b1) ** _f32(step))
    corr2 = float(1.0 - _f32(b2) ** _f32(step))
    lr_f = float(lr)

    def f32_copy(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.float32, copy=True)

    for name, p in params.items():
        g = grads[name].float()
        m, v = state.m[name], state.v[name]
        # m <- b1 m + (1 - b1) g ; v <- b2 v + (1 - b2) g^2, cast to storage
        m32 = f32_copy(m).mul_(b1).add_(g * (1 - b1))
        v32 = f32_copy(v).mul_(b2).add_(g.square().mul_(1 - b2))
        del g
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        # p <- p - lr (mhat / (sqrt(vhat) + eps) + wd p), from the stored m, v
        upd = m.float().div(corr1)
        upd.div_(v.float().div(corr2).sqrt_().add_(eps))
        pf = f32_copy(p)
        upd.add_(pf * wd)
        p.copy_(pf.sub_(upd.mul_(lr_f)))
        del upd, pf
    return params, AdamState(step=step, m=state.m, v=state.v), {"lr": lr}
