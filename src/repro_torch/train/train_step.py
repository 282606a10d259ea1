"""One training step on one device: the port of ``repro.train.train_step``
without the pjit shardings and the cross-pod gradient reduction.

loss + grad (micro-batch accumulation when ``microbatches > 1``: the batch
is split along its rows, the gradients summed in f32 and divided by the
number of micro-batches, as the JAX package's ``lax.scan`` accumulation) ->
clip by the global norm -> AdamW. Metrics: ``loss``, ``ce``, with experts
the MoE aux values ``moe_lb_loss``, ``moe_z_loss`` and ``moe_drop_frac``
(which the JAX step computes and does not return), ``grad_norm``, ``lr``,
each a scalar tensor (read them after the step; reading one waits for the
device).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ParallelConfig, TrainConfig
from repro_torch.models.model import Model
from repro_torch.models.moe import AUX_KEYS
from repro_torch.train.optimizer import AdamState, adam_update, clip_by_global_norm

Batch = Dict[str, torch.Tensor]


def _split_microbatches(batch: Batch, n: int) -> list:
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def _logged(model: Model) -> Tuple[str, ...]:
    """The loss metrics a step reports: with experts, the MoE aux values too."""
    return ("loss", "ce") + (AUX_KEYS if model.cfg.num_experts else ())


def value_and_grad(model: Model, batch: Batch) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(metrics ``loss``, ``ce`` and with experts the MoE aux values, the
    gradient of every parameter by name)."""
    names, params = zip(*model.named_parameters())
    loss, metrics = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, params)
    return {k: metrics[k].detach() for k in _logged(model)}, dict(zip(names, grads))


def accumulated_grads(model: Model, batch: Batch, micro: int
                      ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """``value_and_grad`` over ``micro`` micro-batches: f32 sums of their
    grads, and of their metrics, divided by ``micro`` (the batch as it is
    when ``micro`` is 1)."""
    if micro > 1:
        grads, msum = None, dict.fromkeys(_logged(model), 0.0)
        for one in _split_microbatches(batch, micro):
            m, g = value_and_grad(model, one)
            if grads is None:
                grads = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                         for k, t in g.items()}
            for k, t in g.items():
                grads[k] += t
            msum = {k: msum[k] + m[k] for k in msum}
        grads = {k: t / micro for k, t in grads.items()}
        return {k: v / micro for k, v in msum.items()}, grads
    return value_and_grad(model, batch)


def train_step(model: Model, opt_state: AdamState, batch: Batch, par: ParallelConfig,
               train: TrainConfig) -> Tuple[AdamState, dict]:
    """Updates the model's parameters in place; returns (opt_state, metrics)."""
    metrics, grads = accumulated_grads(model, batch, max(par.microbatches, 1))
    grads, gnorm = clip_by_global_norm(grads, train.grad_clip)
    params = dict(model.named_parameters())
    _, opt_state, om = adam_update(params, grads, opt_state, train)
    return opt_state, dict(metrics, grad_norm=gnorm, **om)
