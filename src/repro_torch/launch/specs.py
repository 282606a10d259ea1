"""Input specs: ``meta`` tensors in place of every model input, with their
partition specs; the port of ``repro.launch.specs``.

A ``meta`` tensor has a shape and a dtype and no storage, as JAX's
``ShapeDtypeStruct``; the dry run (``launch.dryrun``) runs the step on them.
The partition specs are the port's ``P`` tuples with JAX's meaning. Token ids
and labels are int64, the port's convention (``models.model``), where JAX's
are int32. ``shard_shape`` gives a leaf's per-rank shard under its spec, as
GSPMD would place it. A train cell's ranks hold exactly those shards
(``train_step.ShardedStep``), so its ``argument_size_in_bytes`` equals
``argument_size_in_bytes_under_rules``, and JAX's differs from both by the
token ids' and labels' 4 bytes a token (int32 there) and by JAX's step
count, an int32 scalar argument that the port keeps as a host int.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig, ParallelConfig, ShapeSpec
from repro_torch.device import dtype_of
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import P, ShardingRules, _tree_map
from repro_torch.serve.kvcache import cache_shape_specs
from repro_torch.train.optimizer import AdamState, init_adam

META = torch.device("meta")


def _batch_axes_or_none(par: ParallelConfig, batch: int) -> Optional[tuple]:
    """Batch sharding axes only when the batch divides them (long_500k has
    global_batch=1 -> replicate)."""
    n = {"pod": par.pods, "data": par.data, "model": par.model}
    axes = par.batch_axes()
    return axes if batch % math.prod(n[a] for a in axes) == 0 else None


def _inputs(model: ModelConfig, b: int, s: int, axes) -> Tuple[torch.Tensor, P]:
    """Token ids [b, s], or embeddings [b, s, d] in the activation dtype, and
    their spec."""
    if model.embed_inputs:
        return (torch.empty((b, s), dtype=torch.int64, device=META),
                P(axes, None) if axes else P(None, None))
    return (torch.empty((b, s, model.d_model), dtype=dtype_of(model.act_dtype), device=META),
            P(axes, None, None) if axes else P(None, None, None))


def train_input_specs(model: ModelConfig, par: ParallelConfig, shape: ShapeSpec
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, P]]:
    b, s = shape.global_batch, shape.seq_len
    axes = _batch_axes_or_none(par, b)
    key = "tokens" if model.embed_inputs else "embeds"
    inp, inp_p = _inputs(model, b, s, axes)
    specs = {key: inp, "labels": torch.empty((b, s), dtype=torch.int64, device=META)}
    pspecs = {key: inp_p, "labels": P(axes, None) if axes else P(None, None)}
    return specs, pspecs


def prefill_input_specs(model: ModelConfig, par: ParallelConfig, shape: ShapeSpec
                        ) -> Tuple[torch.Tensor, P]:
    b, s = shape.global_batch, shape.seq_len
    return _inputs(model, b, s, _batch_axes_or_none(par, b))


def decode_input_specs(model: ModelConfig, par: ParallelConfig, shape: ShapeSpec):
    """(cache_specs, cache_pspecs, inp_spec, inp_pspec, pos_spec)."""
    b, s = shape.global_batch, shape.seq_len
    axes = _batch_axes_or_none(par, b)
    cache = cache_shape_specs(model, b, s, dtype_of(model.act_dtype))
    cache_pspecs = ShardingRules(model, par).cache_tree_specs(cache)
    if axes is None:
        # replicate the batch dim everywhere
        cache_pspecs = _tree_map(
            lambda sp: P(*[None if (isinstance(ax, tuple) or ax in ("pod", "data")) else ax
                           for ax in sp]), cache_pspecs)
    if model.embed_inputs:
        inp = torch.empty((b,), dtype=torch.int64, device=META)
        inp_p = P(axes) if axes else P()
    else:
        inp = torch.empty((b, 1, model.d_model), dtype=dtype_of(model.act_dtype), device=META)
        inp_p = P(axes, None, None) if axes else P(None, None, None)
    pos = torch.empty((), dtype=torch.int64, device=META)
    return cache, cache_pspecs, inp, inp_p, pos


def params_and_opt_specs(modelobj: Model, par: ParallelConfig, with_opt: bool = True):
    """(params, their specs, AdamState of the moments, its specs): the meta
    model's parameters by name and the moments on meta in
    ``par.opt_state_dtype``."""
    params = dict(modelobj.named_parameters())
    pspecs = ShardingRules(modelobj.cfg, par).params_tree_specs(params)
    if not with_opt:
        return params, pspecs, None, None
    opt = init_adam({k: p.detach() for k, p in params.items()}, par.opt_state_dtype)
    return params, pspecs, opt, AdamState(step=P(), m=pspecs, v=pspecs)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

def shard_shape(shape: tuple, spec, sizes: Mapping[str, int]) -> tuple:
    """A leaf's per-rank shard under ``spec`` on a mesh of ``sizes`` (axis
    name -> ranks): each dim divided by the product of its axes' sizes,
    rounded up."""
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        n = math.prod(sizes[a] for a in axes)
        out[d] = -(-out[d] // n)
    return tuple(out)


def mesh_sizes(par: ParallelConfig) -> Dict[str, int]:
    return dict(zip(par.axis_names(), par.mesh_shape()))


def tree_bytes(tree: Any, spec_tree: Any = None, sizes: Mapping[str, int] = None) -> int:
    """Bytes of a tree of tensors (dicts, lists, ``AdamState``), whole or,
    with ``spec_tree`` and ``sizes``, of one rank's shards."""
    leaves = list(_leaves(tree))
    specs = list(_leaves(spec_tree, is_spec=True)) if spec_tree is not None else None
    total = 0
    for i, t in enumerate(leaves):
        shape = tuple(t.shape) if specs is None else shard_shape(tuple(t.shape), specs[i], sizes)
        total += math.prod(shape) * t.element_size()
    return total


def _leaves(tree: Any, is_spec: bool = False):
    if isinstance(tree, AdamState):
        tree = {"m": tree.m, "v": tree.v}     # the step count is a host int
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v, is_spec)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for v in tree:
            yield from _leaves(v, is_spec)
    else:
        yield tree
