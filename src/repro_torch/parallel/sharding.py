"""Sharding rules: map every parameter / activation / cache leaf to a
partition spec, and a spec to DTensor placements on a ``DeviceMesh``; the
port of ``repro.parallel.sharding``.

Layout (Megatron 2D + optional FSDP/ZeRO-3):
  * "model" shards heads (attention), d_ff (MLP), experts (MoE), d_inner
    (SSD), the rnn width (RG-LRU) and the vocab dim of the embeddings;
  * "data" (optionally, ``fsdp``) shards the other weight dim: parameters
    and optimizer state fully sharded over data x model;
  * "pod" replicates parameters (a pod is an AI-DC; only gradients cross the
    pod axis);
  * batches shard over ("pod", "data"); a heads dim shards over "model" only
    when divisible.

A spec is a ``P``: one entry per tensor dim, an axis name, a tuple of axis
names (the dim split over them, the first major) or None (replicated), as a
JAX ``PartitionSpec``. Rules are keyed by the leaf's path: the port's
``named_parameters`` names (``backbone.layers.3.attn.wq``; "/"-joined paths
are read too). The port keeps one module per layer, so no path has the
JAX package's layer-stack lead dim (``/groups/``): each spec is JAX's spec
of the stacked leaf without its lead ``None``.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Iterator, NamedTuple, Sequence

from repro_torch.config.base import ModelConfig, ParallelConfig


class P(tuple):
    """A partition spec: ``P("model", None)``; a one-name tuple entry is that
    name, as in a JAX ``PartitionSpec``."""

    def __new__(cls, *dims):
        return super().__new__(cls, (d[0] if isinstance(d, tuple) and len(d) == 1 else d
                                     for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _parts(path: str) -> list:
    return [p for p in re.split(r"[./]", path) if p]


class ShardingRules:
    """Resolves partition specs for one (model, parallel) configuration."""

    def __init__(self, model: ModelConfig, par: ParallelConfig):
        self.model = model
        self.par = par
        self.fsdp = "data" if par.fsdp else None
        self.n_model = par.model
        # shard the heads dim itself (cache layout [B,S,H,hd] and the
        # per-head compute both need head-count divisibility)
        self.q_shardable = _div(model.num_heads, self.n_model)
        self.kv_shardable = _div(model.num_kv_heads, self.n_model)
        self.ff_shardable = _div(model.d_ff, self.n_model)
        self.vocab_shardable = _div(model.vocab_size, self.n_model)
        # grouped (per-batch-row) MoE dispatch keeps routing local to the
        # data shard: expert weights are replicated over "model" (EP -> DP)
        self.experts_shardable = (_div(model.num_experts, self.n_model)
                                  and not model.moe_group_by_batch)
        d_in = model.ssm_expand * model.d_model
        self.ssd_shardable = _div(d_in, self.n_model) and _div(
            d_in // max(model.ssm_headdim, 1), self.n_model)
        w = model.rglru_width or model.d_model
        self.rglru_shardable = _div(w, self.n_model)
        # decode caches split along the sequence over "model" (cache_spec)
        self.cache_seq_split = (self.n_model > 1 and not self.kv_shardable
                                and par.shard_cache_seq)

    # -- param rules -------------------------------------------------------
    def param_spec(self, path: str, ndim: int) -> P:
        """path: the parameter's name, e.g. 'backbone.layers.0.attn.wq'."""
        parts = _parts(path)
        name = parts[-1]
        mdl, f = "model", self.fsdp
        rest = (None,) * ndim

        if name == "tok":
            return P(mdl if self.vocab_shardable else None, f)
        if name == "unembed":
            return P(f, mdl if self.vocab_shardable else None)
        # attention
        if name == "wq":
            return P(f, mdl if self.q_shardable else None)
        if name in ("wk", "wv"):
            return P(f, mdl if self.kv_shardable else None)
        if name == "wo":
            return P(mdl if self.q_shardable else None, f)
        if name == "bq":
            return P(mdl if self.q_shardable else None)
        if name in ("bk", "bv"):
            return P(mdl if self.kv_shardable else None)
        # dense MLP
        if name in ("w_gate", "w_up") and ndim == 2:
            return P(f, mdl if self.ff_shardable else None)
        if name == "w_down" and ndim == 2:
            return P(mdl if self.ff_shardable else None, f)
        # MoE experts [E, d, f] / [E, f, d]; router [d, E]
        if name in ("w_gate", "w_up") and ndim == 3:
            return P(mdl if self.experts_shardable else None, f, None)
        if name == "w_down" and ndim == 3:
            return P(mdl if self.experts_shardable else None, None, f)
        if name == "router":
            return P(f, None)
        # SSD (Mamba2)
        s = mdl if self.ssd_shardable else None
        if name in ("w_z", "w_x"):     # RG-LRU's w_x too, as in the JAX rules
            return P(f, s)
        if name in ("w_bc", "w_dt"):
            return P(f, None)
        if name == "conv_x_w":
            return P(None, s)
        if name in ("conv_x_b", "norm_scale"):
            return P(s)
        if name in ("conv_bc_w", "conv_bc_b"):
            return P(*rest)
        if name in ("A_log", "D", "dt_bias"):
            return P(s)
        if name == "w_out" and "ssd" in parts:
            return P(s, f)
        # RG-LRU
        if "rglru" in parts:
            r = mdl if self.rglru_shardable else None
            if name in ("w_x", "w_gate"):
                return P(f, r)
            if name in ("w_a", "w_i", "conv_w"):
                return P(None, r)
            if name in ("conv_b", "b_a", "b_i", "lam"):
                return P(r)
            if name == "w_out":
                return P(r, f)
        # norms / scalars / anything else: replicated
        return P(*rest)

    def params_tree_specs(self, params) -> Any:
        """Spec tree of a parameter tree: a name -> tensor dict (``dict(
        model.named_parameters())``) or nested dicts/lists of tensors."""
        return _tree_map_path(lambda path, t: self.param_spec(path, t.dim()), params)

    # -- activation / batch rules ------------------------------------------
    def batch_axes(self) -> tuple:
        return self.par.batch_axes()

    def data_spec(self, ndim: int) -> P:
        """Input batches: the batch dim sharded over (pod, data)."""
        return P(self.batch_axes(), *([None] * (ndim - 1)))

    def hidden_spec(self) -> P:
        return P(self.batch_axes(), None, None)

    # -- cache rules ---------------------------------------------------------
    def cache_spec(self, path: str, ndim: int) -> P:
        """Decode caches. Attention k/v [B, S, Hk, hd]: batch over (pod,)
        data, then kv-heads over model if divisible, else the sequence over
        model (flash-decode layout); a time-minor K [B, Hk, hd, S] likewise.
        SSM / conv / RG-LRU states: batch only."""
        name = _parts(path)[-1]
        b = self.batch_axes()
        if name == "k" and self.model.decode_k_time_minor:
            if self.kv_shardable:
                return P(b, "model", None, None)
            if self.par.shard_cache_seq:
                return P(b, None, None, "model")
            return P(b, None, None, None)
        if name in ("k", "v"):
            if self.kv_shardable:
                return P(b, None, "model", None)
            if self.par.shard_cache_seq:
                return P(b, "model", None, None)
            return P(b, None, None, None)
        return P(b, *([None] * (ndim - 1)))

    def cache_tree_specs(self, caches) -> Any:
        """Spec tree of a cache list (one dict per layer, ``init_caches``)."""
        return _tree_map_path(lambda path, t: self.cache_spec(path, t.dim()), caches)


def _tree_map_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map_path(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _tree_map(fn, tree):
    return _tree_map_path(lambda _, leaf: fn(leaf), tree)


class Sharding(NamedTuple):
    """A spec resolved on a mesh: DTensor placements, one per mesh dim."""
    mesh: Any                 # torch.distributed.device_mesh.DeviceMesh
    placements: tuple


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim named at tensor dim ``d``, ``Replicate()`` on the others. A tensor dim
    split over several axes must name them in the mesh's order (DTensor
    splits a dim over mesh dims major to minor)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} is split over {axes}, not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """The spec tree resolved on ``mesh``: a ``Sharding`` per spec."""
    return _tree_map(lambda s: Sharding(mesh, placements(mesh, s)), spec_tree)


def split_dims(mesh, placements) -> tuple:
    """The mesh dims of more than one rank that split a tensor so placed."""
    from torch.distributed.tensor import Shard

    return tuple(m for m, p in enumerate(placements)
                 if isinstance(p, Shard) and mesh.size(m) > 1)


def shard_of(t, mesh, placements):
    """This rank's shard of ``t`` (a view): DTensor's split of each ``Shard``
    dim, ``torch.chunk``'s, in mesh-dim order; ``t`` itself when no dim of
    more than one rank splits it. Its shape and offset along each split dim
    are ``shard_range``'s."""
    for m in split_dims(mesh, placements):
        d, n, i = placements[m].dim, mesh.size(m), mesh.get_local_rank(m)
        off, length = shard_range(t.shape[d], n, i)
        t = t.narrow(d, off, length)
    return t


def shard_range(size: int, n: int, i: int) -> tuple:
    """(offset, length) of part ``i`` of a dim of ``size`` cut into ``n`` as
    ``torch.chunk`` cuts it (parts of ceil(size / n), the last ones short or
    empty)."""
    c = -(-size // n)
    off = min(i * c, size)
    return off, max(0, min(c, size - off))


# ---------------------------------------------------------------------------
# The ambient mesh (the JAX package's ``set_mesh`` / ``get_ambient_mesh``)
# ---------------------------------------------------------------------------

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Makes ``mesh`` the ambient mesh inside the block. Under it a layer
    that mixes batch rows (the MoE's routing) takes a plain tensor for this
    rank's rows of a batch split over the mesh's batch dims (``batch_dims``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_ambient_mesh():
    """The mesh of the innermost ``use_mesh``, or None outside any."""
    return _AMBIENT[-1] if _AMBIENT else None


def batch_dims(mesh) -> tuple:
    """The mesh's batch dims, of ("pod", "data"), in mesh order."""
    if mesh is None:
        return ()
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
