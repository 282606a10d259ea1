"""Train steps: the port of ``repro.train.train_step``.

``train_step`` is one step on one device: loss + grad (micro-batch accumulation when ``microbatches > 1``: the batch
is split along its rows, the gradients summed in f32 and divided by the
number of micro-batches, as the JAX package's ``lax.scan`` accumulation) ->
clip by the global norm -> AdamW. Metrics: ``loss``, ``ce``, with experts
the MoE aux values ``moe_lb_loss``, ``moe_z_loss`` and ``moe_drop_frac``
(which the JAX step computes and does not return), ``grad_norm``, ``lr``,
each a scalar tensor (read them after the step; reading one waits for the
device).

``make_train_step(model, par, train, mesh)`` returns ``(step, init_fn,
jit_step, rules)`` as the JAX package's does. ``jit_step(params)`` gives the
step on ``mesh``, which computes as GSPMD runs the JAX step under
``ShardingRules``: ``place`` puts this rank's shard of each parameter into
the model (``parallel.tensor.shard_model``: exactly the rules' shard shapes)
and the layers compute on those shards, tensor-parallel over "model"
(heads, d_ff, experts, SSD heads, the RG-LRU width and the vocab; Megatron's
column- and row-parallel matmuls, the vocab-parallel embedding and
cross-entropy, expert parallelism) and, under ``fsdp``, ZeRO-3 over "data"
(a parameter's "data" shards gathered just before its layer uses it, its
gradient reduce-scattered). The AdamW moments are DTensors placed by the
same rules (replicated over "pod"), and the batch is split over
``par.batch_axes()``. A step runs the forward and the backward on this
rank's rows of the batch with the loss normalised by the whole batch's
token count; the gradient of a split parameter comes out of the backward as
this rank's shard, and each gradient is all-reduced over the batch dims
that do not split it (under ZeRO-3 the backward's reduce-scatter has summed
it over "data"). Then the global norm from one all-reduce of the shards'
sums of squares, the clip, and AdamW (elementwise) on the shards of the
parameters and moments in place. No parameter is gathered whole; ``full``
gathers them for a checkpoint and ``unplace`` puts them back whole into the
model. On a mesh of one rank every shard is the whole tensor: no collective
runs and no parameter is copied, so the step is ``train_step``'s
arithmetic. Mixing across batch rows goes through explicit collectives under
the ambient mesh (``parallel.use_mesh``): the MoE's routing (each rank its
rows with ``moe_group_by_batch``, else every row together) and its aux
values. With micro-batches each rank splits its own rows, which is the JAX
split (global row chunks) when every micro-batch has the same unmasked token
count and no MoE routes across rows.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.config.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.models.model import Model, chunked_ce_loss
from repro_torch.models.moe import AUX_KEYS
from repro_torch.parallel.sharding import (
    ShardingRules, batch_dims, named, shard_of, split_dims, use_mesh,
)
from repro_torch.parallel.tensor import shard_model, split_of, unshard_model
from repro_torch.train.optimizer import (
    AdamState, adam_update, clip_by_global_norm, global_norm, init_adam,
)

Batch = Dict[str, torch.Tensor]


def _split_microbatches(batch: Batch, n: int) -> list:
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def _logged(model: Model) -> Tuple[str, ...]:
    """The loss metrics a step reports: with experts, the MoE aux values too."""
    return ("loss", "ce") + (AUX_KEYS if model.cfg.num_experts else ())


Objective = Callable[[Model, Batch], Tuple[torch.Tensor, dict]]


def model_loss(model: Model, batch: Batch) -> Tuple[torch.Tensor, dict]:
    """(the loss, the metrics a step reports): ``Model.loss_fn``."""
    loss, metrics = model.loss_fn(batch)
    return loss, {k: metrics[k].detach() for k in _logged(model)}


def value_and_grad(model: Model, batch: Batch, objective: Objective = model_loss
                   ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(metrics ``loss``, ``ce`` and with experts the MoE aux values, the
    gradient of ``objective``'s loss for every parameter by name)."""
    names, params = zip(*model.named_parameters())
    loss, metrics = objective(model, batch)
    grads = torch.autograd.grad(loss, params)
    return metrics, dict(zip(names, grads))


def accumulated_grads(model: Model, batch: Batch, micro: int,
                      objective: Objective = model_loss
                      ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """``value_and_grad`` over ``micro`` micro-batches: f32 sums of their
    grads, and of their metrics, divided by ``micro`` (the batch as it is
    when ``micro`` is 1)."""
    if micro > 1:
        grads, msum = None, dict.fromkeys(_logged(model), 0.0)
        for one in _split_microbatches(batch, micro):
            m, g = value_and_grad(model, one, objective)
            if grads is None:
                grads = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                         for k, t in g.items()}
            for k, t in g.items():
                grads[k] += t
            msum = {k: msum[k] + m[k] for k in msum}
        grads = {k: t / micro for k, t in grads.items()}
        return {k: v / micro for k, v in msum.items()}, grads
    return value_and_grad(model, batch, objective)


def train_step(model: Model, opt_state: AdamState, batch: Batch, par: ParallelConfig,
               train: TrainConfig) -> Tuple[AdamState, dict]:
    """Updates the model's parameters in place; returns (opt_state, metrics)."""
    metrics, grads = accumulated_grads(model, batch, max(par.microbatches, 1))
    grads, gnorm = clip_by_global_norm(grads, train.grad_clip)
    params = dict(model.named_parameters())
    _, opt_state, om = adam_update(params, grads, opt_state, train)
    return opt_state, dict(metrics, grad_norm=gnorm, **om)


# ---------------------------------------------------------------------------
# The step on a mesh
# ---------------------------------------------------------------------------

def batch_specs(model: ModelConfig, rules: ShardingRules) -> dict:
    key = "tokens" if model.embed_inputs else "embeds"
    ndim = 2 if model.embed_inputs else 3
    return {key: rules.data_spec(ndim), "labels": rules.data_spec(2)}


def _dim_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _sum_over(t: torch.Tensor, mesh, dims: tuple) -> torch.Tensor:
    """``t`` summed over the ranks of the batch dims (in place)."""
    for name in dims:
        if _dim_size(mesh, name) > 1:
            dist.all_reduce(t, group=mesh.get_group(name))
    return t


def _rank_objective(model: Model, batch: Batch, mesh, dims: tuple) -> Tuple[torch.Tensor, dict]:
    """(this rank's share of the loss, the loss metrics of the whole batch).

    The shares sum to the loss over all ranks' rows: the token losses of the
    rank's rows over the whole batch's unmasked tokens, plus the MoE aux
    terms (the same on every rank) over the number of batch ranks."""
    cfg = model.cfg
    inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
    h, aux, _ = model.backbone(model.embed(inputs), mode="train", remat=model.remat)
    tot, cnt = chunked_ce_loss(h, model.embed.weight(), batch["labels"], cfg.logit_softcap,
                               split_of(model.embed))
    counts = _sum_over(torch.stack([tot.detach(), cnt.detach()]), mesh, dims)
    denom = torch.clamp(counts[1], min=1.0)
    ce = counts[0] / denom
    share, loss = tot / denom, ce
    if cfg.num_experts:
        extra = cfg.router_aux_loss * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        n = 1
        for name in dims:
            n *= _dim_size(mesh, name)
        share = share + extra / n
        loss = loss + cfg.router_aux_loss * aux["moe_lb_loss"].detach() \
            + 1e-3 * aux["moe_z_loss"].detach()          # the order of Model.loss_fn
    metrics = {"loss": loss, "ce": ce, **{k: aux[k].detach() for k in AUX_KEYS}}
    return share, {k: metrics[k] for k in _logged(model)}


def _rank_grads(model: Model, batch: Batch, micro: int, mesh, dims: tuple, reduce: dict
                ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(metrics, gradients of the loss over the whole batch): this rank's
    ``accumulated_grads`` of its share, each summed over the batch dims
    ``reduce`` names for it."""
    with use_mesh(mesh):    # the backward's recompute (remat) runs under it too
        metrics, grads = accumulated_grads(
            model, batch, micro, lambda m, b: _rank_objective(m, b, mesh, dims))
    return metrics, {n: _sum_over(g.contiguous(), mesh, reduce[n]) for n, g in grads.items()}


_shard_of = shard_of     # the name it had when it lived in this module


class ShardedStep:
    """The train step on a mesh (see the module docstring):
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)`` with
    ``params`` the model's parameters by name (this rank's shards once
    ``place`` has run) and the moments DTensors, both updated in place, and
    ``batch`` the whole batch on every rank (each rank keeps its rows, split
    over the batch dims, no collective)."""

    def __init__(self, model: Model, par: ParallelConfig, train: TrainConfig, mesh,
                 rules: ShardingRules, param_specs: dict):
        self.model, self.par, self.train, self.mesh = model, par, train, mesh
        self.rules = rules
        self.param_pl = {k: s.placements for k, s in named(mesh, param_specs).items()}
        self.batch_pl = {k: s.placements
                         for k, s in named(mesh, batch_specs(model.cfg, rules)).items()}
        self.dims = batch_dims(mesh)
        self.split = {k: split_dims(mesh, pl) for k, pl in self.param_pl.items()}
        names = mesh.mesh_dim_names
        self.reduce = {k: tuple(a for a in self.dims if names.index(a) not in sd)
                       for k, sd in self.split.items()}
        self.shapes = dict(getattr(model, "whole_shapes", None)
                           or {k: p.shape for k, p in model.named_parameters()})
        # a rank adds its shards' squares to the global norm when it is the
        # first of their replicas (coordinate 0 on every dim not splitting them)
        coords = [mesh.get_local_rank(m) for m in range(mesh.ndim)]
        self.counts = {k: all(coords[m] == 0 for m in range(mesh.ndim) if m not in sd)
                       for k, sd in self.split.items()}

    def place(self, params: Dict[str, torch.Tensor], opt_state: Optional[AdamState] = None
              ) -> Tuple[Dict[str, torch.Tensor], AdamState]:
        """(the model's parameters, holding this rank's shards of ``params``'
        whole values; the moments as DTensors placed by the rules). The
        moments are ``opt_state``'s (whole, the same on every rank: each rank
        keeps its shard, no collective), or without it zeros in
        ``par.opt_state_dtype`` of which each rank allocates only its shard.
        The first call splits the model (``shard_model``)."""
        own = dict(self.model.named_parameters())
        with torch.no_grad():
            for k, t in params.items():
                t, p = t.detach(), own[k]
                if t.shape != p.shape:          # whole values for a model already split
                    t = shard_of(t, self.mesh, self.param_pl[k])
                if t.device.type == "meta" or t.data_ptr() != p.data_ptr():
                    p.copy_(t)
        if not getattr(self.model, "sharded", False):
            shard_model(self.model, self.mesh, self.rules)

        def put(tree):
            out = {}
            for k, t in tree.items():
                local = shard_of(t.detach(), self.mesh, self.param_pl[k])
                if local.shape != t.shape:
                    local = local.clone()      # frees the whole tensor's storage
                out[k] = self._dtensor(k, local)
            return out
        if opt_state is None:
            zeros = init_adam({k: p.detach() for k, p in own.items()}, self.par.opt_state_dtype)
            return own, AdamState(step=zeros.step,
                                  m={k: self._dtensor(k, t) for k, t in zeros.m.items()},
                                  v={k: self._dtensor(k, t) for k, t in zeros.v.items()})
        return own, AdamState(step=opt_state.step, m=put(opt_state.m), v=put(opt_state.v))

    def _dtensor(self, k: str, local: torch.Tensor) -> DTensor:
        """``local``, this rank's shard of the whole parameter ``k``'s shape,
        as a DTensor placed by the rules."""
        shape = torch.Size(self.shapes[k])
        return DTensor.from_local(local, self.mesh, self.param_pl[k], run_check=False,
                                  shape=shape, stride=torch.empty(shape, device="meta").stride())

    def full(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each parameter whole (an all-gather over the dims that split it;
        the parameter itself where none does)."""
        out = {}
        for k, p in params.items():
            p = p.detach()
            if self.split[k]:
                p = self._dtensor(k, p.contiguous()).full_tensor()
            out[k] = p
        return out

    def unplace(self, params: Dict[str, torch.Tensor]) -> None:
        """Puts every parameter back whole into the model (``full``), which
        then computes whole again."""
        if getattr(self.model, "sharded", False):
            unshard_model(self.model, {k: t for k, t in self.full(params).items()
                                       if self.split[k]})

    def _rows(self, batch: Batch) -> Batch:
        """This rank's rows of the batch."""
        return {k: shard_of(v, self.mesh, self.batch_pl[k]) for k, v in batch.items()}

    def _global_norm(self, shards: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient tree from the shards: each rank's
        sums of squares, by the set of mesh dims splitting them, summed over
        the mesh in one all-reduce (``global_norm``'s sum on one rank)."""
        if self.mesh.size() == 1:
            return global_norm(shards)
        sums: dict = {}
        for k, g in shards.items():
            part = torch.sum(torch.square(g.float()))
            sums[self.split[k]] = sums.get(self.split[k], 0) + (part if self.counts[k]
                                                               else torch.zeros_like(part))
        vec = torch.stack(list(sums.values()))
        dist.all_reduce(vec)
        return torch.sqrt(sum(vec.unbind()))

    def __call__(self, params: Dict[str, torch.Tensor], opt_state: AdamState, batch: Batch):
        return self.step_rows(params, opt_state, self._rows(batch))

    def step_rows(self, params: Dict[str, torch.Tensor], opt_state: AdamState, rows: Batch):
        """The step on this rank's rows of the batch (``__call__`` takes them
        from the whole batch; the dry run gives them alone)."""
        metrics, grads = _rank_grads(self.model, rows, max(self.par.microbatches, 1),
                                     self.mesh, self.dims, self.reduce)
        grads, gnorm = clip_by_global_norm(grads, self.train.grad_clip,
                                           self._global_norm(grads))
        # AdamW is elementwise: it runs on this rank's shards of the
        # parameters and of the moments, in place
        _, state, om = adam_update(
            {k: p.detach() for k, p in params.items()}, grads,
            AdamState(step=opt_state.step,
                      m={k: t.to_local() for k, t in opt_state.m.items()},
                      v={k: t.to_local() for k, t in opt_state.v.items()}),
            self.train)
        del grads
        opt_state = AdamState(step=state.step, m=opt_state.m, v=opt_state.v)
        return params, opt_state, dict(metrics, grad_norm=gnorm, **om)


def make_train_step(model: Model, par: ParallelConfig, train: TrainConfig, mesh):
    """Returns (step, init_fn, jit_step, rules):

    * ``step(opt_state, batch) -> (opt_state, metrics)``: ``train_step`` on
      one device, the model's parameters updated in place;
    * ``init_fn(seed) -> (params, opt_state)``: the model's parameters drawn
      from ``seed`` (a name -> tensor dict of them) and zero moments;
    * ``jit_step(params) -> ShardedStep``: the step on ``mesh`` for a
      parameter tree of that structure;
    * ``rules``: the ``ShardingRules`` of (model, par)."""
    rules = ShardingRules(model.cfg, par)

    def step(opt_state: AdamState, batch: Batch):
        return train_step(model, opt_state, batch, par, train)

    def init_fn(seed: int):
        model.reset_parameters(torch.Generator(device=model.device).manual_seed(seed))
        params = dict(model.named_parameters())
        return params, init_adam(params, par.opt_state_dtype)

    def jit_step(params: Dict[str, torch.Tensor]) -> ShardedStep:
        return ShardedStep(model, par, train, mesh, rules, rules.params_tree_specs(params))

    return step, init_fn, jit_step, rules


def lower_train_step(model: Model, par: ParallelConfig, train: TrainConfig, mesh,
                     params_spec_tree, batch_specs_tree):
    """The dry run's entry (``launch.dryrun``), with JAX's signature and
    result ``(step, rules)``: ``step`` is the ``ShardedStep`` of ``model``'s
    parameters (on ``meta`` there) on ``mesh``, the step that
    ``launch.train`` runs, so the dry run measures it. ``params_spec_tree``
    must be the rules' specs of those parameters (it is checked);
    ``batch_specs_tree`` is the batch's, which the step takes from the rules
    too (each rank keeps its rows of the batch dims). JAX's dry run writes a
    step of its own and calls nothing of this name."""
    _, _, jit_step, rules = make_train_step(model, par, train, mesh)
    params = dict(model.named_parameters())
    if rules.params_tree_specs(params) != params_spec_tree:
        raise ValueError("params_spec_tree is not the rules' specs of the model's parameters")
    if set(batch_specs_tree) != set(batch_specs(model.cfg, rules)):
        raise ValueError(f"batch keys {sorted(batch_specs_tree)} are not the model's "
                         f"{sorted(batch_specs(model.cfg, rules))}")
    return jit_step(params), rules
