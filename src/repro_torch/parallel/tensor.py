"""Tensor-parallel compute over "model" and ZeRO-3 over "data": what GSPMD
makes of the JAX package's train step under ``ShardingRules``.

``shard_model(model, mesh, rules)`` replaces every parameter that the rules
split over a mesh dim of more than one rank by this rank's shard (a view of
the whole value is cloned, so the whole tensor's storage goes) and marks
the modules that own them (and sets ``model.sharded`` and ``model.whole_shapes``):

* ``module.tp`` (a ``Split``: the "model" group, this rank's index in it,
  its size) on a module whose parameters the rules split over "model". Such
  a layer computes on its shards, Megatron style: the activations between
  layers stay whole on every rank of a model group, a column-parallel
  matmul takes ``copy_to_model(x)`` and a row-parallel one ends in
  ``reduce_from_model``. A module left unmarked computes whole, as on one
  device (recurrentgemma's 10 attention heads on 16 ranks);
* ``module.seq_split`` (a ``Split`` of "model") on each module holding a
  K/V cache (``wk``) when the rules keep the kv heads whole and split the
  cache along its sequence instead (``ShardingRules.cache_spec``): its
  prefill and decode keep this rank's slice of the positions (of a ring's
  slots) and combine their partial softmaxes over "model";
* ``module.zero`` (name -> (tensor dim, "data" group)) for each parameter
  that the rules split over "data" (``fsdp``). ``weight(module, name)``
  gives the tensor a layer computes with: the parameter itself, or under
  ZeRO-3 its shards all-gathered over "data" just before the layer uses it
  (and, rematerialised, gathered again in the backward rather than kept),
  whose gradient is reduce-scattered back over "data".

The conjugate pair (Megatron's f and g): ``copy_to_model`` is the identity
forward and an all-reduce over "model" backward; ``reduce_from_model`` is
an all-reduce forward and the identity backward. ``scatter_to_model`` takes
this rank's slice of a whole activation (backward: all-gather) and
``gather_from_model`` all-gathers a width-split activation (backward: this
rank's slice). ``sum_over_model`` is an all-reduce both ways, for a sum
whose result the rank's own shards use (the gated norm's mean of squares).
With no mark nothing here runs: a mesh of one rank computes exactly as one
device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.parallel.collectives import _AllReduceSum
from repro_torch.parallel.compression import all_gather_stacked
from repro_torch.parallel.sharding import ShardingRules, named, shard_of, split_dims


class Split(NamedTuple):
    """A layer's split over "model": the group, this rank's index, its size."""
    group: object
    rank: int
    size: int

    def part(self, whole: int) -> tuple:
        """(offset, length) of this rank's slice of a dim of ``whole``."""
        n = whole // self.size
        return self.rank * n, n


# ---------------------------------------------------------------------------
# Collectives with their conjugate backwards
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank order."""
    parts = all_gather_stacked(x.movedim(dim, 0).contiguous(), group)   # [n, x_d, ...]
    whole = parts.reshape(-1, *parts.shape[2:]).movedim(0, dim)
    return whole.contiguous()


def _slice_dim(x: torch.Tensor, dim: int, tp: Split) -> torch.Tensor:
    off, n = tp.part(x.shape[dim])
    return x.narrow(dim, off, n).contiguous()


def _reduce_scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``g`` over ``group``, this rank's slice of ``dim``."""
    n = dist.get_world_size(group)
    moved = g.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.group = dim, tp.group
        return _slice_dim(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _gather_dim(x, dim, tp.group)

    @staticmethod
    def backward(ctx, g):
        return _slice_dim(g, ctx.dim, ctx.tp), None, None


class _ZeroGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(p, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, tp: Optional[Split]) -> torch.Tensor:
    """x as it is; its gradient all-reduced over "model" (the input of a
    column-parallel matmul). The identity without a split."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[Split]) -> torch.Tensor:
    """x summed over "model" (the partial output of a row-parallel matmul);
    its gradient as it is. The identity without a split."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def scatter_to_model(x: torch.Tensor, dim: int, tp: Optional[Split]) -> torch.Tensor:
    """This rank's slice of ``dim`` of a whole activation; the gradient
    all-gathered."""
    return x if tp is None else _ScatterToModel.apply(x, dim, tp)


def gather_from_model(x: torch.Tensor, dim: int, tp: Optional[Split]) -> torch.Tensor:
    """A ``dim``-split activation all-gathered over "model"; the gradient
    sliced back."""
    return x if tp is None else _GatherFromModel.apply(x, dim, tp)


def sum_over_model(x: torch.Tensor, tp: Optional[Split]) -> torch.Tensor:
    """x summed over "model", the gradient too (all-reduced both ways)."""
    return x if tp is None else _AllReduceSum.apply(x, tp.group)


def max_over_model(x: torch.Tensor, tp: Optional[Split]) -> torch.Tensor:
    """The elementwise max of ``x`` over "model", with no gradient (a
    softmax's shift)."""
    x = x.detach()
    return x if tp is None else _all_reduce(x, tp.group, dist.ReduceOp.MAX)


def weight(module: nn.Module, name: str) -> torch.Tensor:
    """The parameter ``name`` of ``module`` as its layer computes with it:
    under ZeRO-3 its "data" shards gathered (the gradient reduce-scattered)."""
    p = getattr(module, name)
    zero = getattr(module, "zero", None)
    if not zero or name not in zero:
        return p
    dim, group = zero[name]
    return _ZeroGather.apply(p, dim, group)


def split_of(module: nn.Module) -> Optional[Split]:
    """``module.tp``: its split over "model", or None when it computes whole."""
    return getattr(module, "tp", None)


def groups_of(model: nn.Module) -> list:
    """The process groups that a split model's collectives run over."""
    out = []
    for m in model.modules():
        for split in (getattr(m, "tp", None), getattr(m, "seq_split", None)):
            if split is not None and split.group not in out:
                out.append(split.group)
        for _, group in (getattr(m, "zero", None) or {}).values():
            if group not in out:
                out.append(group)
    return out


# ---------------------------------------------------------------------------
# Placing a model's shards
# ---------------------------------------------------------------------------

def _owner(root: nn.Module, name: str) -> tuple:
    path, _, leaf = name.rpartition(".")
    return (root.get_submodule(path) if path else root), leaf


@torch.no_grad()
def shard_model(model: nn.Module, mesh, rules: ShardingRules) -> dict:
    """Replaces each parameter of ``model`` that the rules split over a mesh
    dim of more than one rank by this rank's shard and marks the modules
    that own them (module docstring), and keeps ``rules`` as
    ``model.rules`` (the cache shapes ``init_caches`` gives). Returns the
    whole shapes of the parameters it split, by name. On a mesh of one rank
    it changes nothing."""
    names = tuple(mesh.mesh_dim_names)
    whole = {}
    shapes = {name: p.shape for name, p in model.named_parameters()}
    for name, p in model.named_parameters():
        pl = named(mesh, rules.param_spec(name, p.dim())).placements
        dims = split_dims(mesh, pl)
        if not dims:
            continue
        module, leaf = _owner(model, name)
        for m in dims:
            axis, d = names[m], pl[m].dim
            if p.shape[d] % mesh.size(m):
                raise ValueError(f"{name} {tuple(p.shape)}: dim {d} does not divide over "
                                 f"{axis!r} ({mesh.size(m)} ranks)")
            if axis == "model":
                module.tp = Split(mesh.get_group("model"), mesh.get_local_rank("model"),
                                  mesh.size(m))
            elif axis == "data":
                zero = getattr(module, "zero", None) or {}
                zero[leaf] = (d, mesh.get_group("data"))
                module.zero = zero
            else:
                raise ValueError(f"{name}: the rules split it over {axis!r}")
        whole[name] = p.shape
        p.data = shard_of(p.data, mesh, pl).clone()
    seq = "model" in names and mesh.size(names.index("model")) > 1 and rules.cache_seq_split
    for m in model.modules() if seq else ():
        if isinstance(getattr(m, "wk", None), nn.Parameter):
            m.seq_split = Split(mesh.get_group("model"), mesh.get_local_rank("model"),
                                mesh.size(names.index("model")))
    if whole or seq:
        model.sharded, model.whole_shapes, model.rules = True, shapes, rules
    return whole


def unshard_model(model: nn.Module, full: dict) -> None:
    """Puts the whole values ``full`` (name -> tensor) back into the
    parameters that ``shard_model`` split and clears the marks: the model
    computes whole again."""
    params = dict(model.named_parameters())
    for name, t in full.items():
        params[name].data = t
    for m in model.modules():
        for attr in ("tp", "seq_split", "zero", "sharded", "whole_shapes", "rules"):
            if attr in m.__dict__:
                delattr(m, attr)
