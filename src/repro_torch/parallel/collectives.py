"""Pod-aware collectives: hierarchical gradient reduction for geo-distributed
training (the framework-level MatchRDMA integration); the port of
``repro.parallel.collectives``.

The pattern that minimizes inter-DC bytes:

    reduce-scatter intra-pod  (full bandwidth)
    all-reduce inter-pod      (OTN: only 1/data of the gradient per rank
                               crosses the long-haul link; optionally int8
                               with error feedback)
    all-gather intra-pod

Each rank calls these on its own copy of a gradient that is replicated over
the ``pod`` and ``data`` mesh dims (JAX's ``shard_map`` body with ``P()``
specs); the collectives run over the mesh's process groups of those dims.
As in the JAX package, nothing in the train step calls them
(``make_train_step`` reduces its gradients with plain all-reduces).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.compression import all_gather_stacked, compressed_psum


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 in rank order; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_stacked(x, group).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum); the backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along dim 0 in rank
    order (differentiable: the gradient is reduce-scattered back)."""
    return _GatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (differentiable)."""
    return _AllReduceSum.apply(x, group)


def hierarchical_grad_reduce(g: torch.Tensor, mesh, *, pod_axis: str = "pod",
                             intra_axis: str = "data", compress: bool = False,
                             err: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mean-reduce ``g`` over (pod_axis, intra_axis) of ``mesh``: equal to
    the sum over those ranks / (n_pod * n_intra), structured so that only
    the scattered shard crosses the pod axis. Returns (g_mean, new_err); the
    error-feedback state ``err`` is full-size (replicated), as JAX keeps it."""
    intra, pod = mesh.get_group(intra_axis), mesh.get_group(pod_axis)
    n_intra, n_pod = mesh.size(mesh.mesh_dim_names.index(intra_axis)), \
        mesh.size(mesh.mesh_dim_names.index(pod_axis))
    idx = mesh.get_local_rank(intra_axis)

    # 1) reduce-scatter intra-pod along a padded leading dim
    pad = (-g.numel()) % n_intra
    flat = torch.nn.functional.pad(g.reshape(-1), (0, pad))
    shard = flat.new_empty(flat.numel() // n_intra)
    dist.reduce_scatter_tensor(shard, flat, group=intra)

    # 2) inter-pod exchange on the shard only
    if compress:
        if err is None:
            err = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        err_pad = torch.nn.functional.pad(err.reshape(-1).to(torch.float32), (0, pad))
        err_shard = err_pad.reshape(n_intra, -1)[idx]
        shard, new_err_shard = compressed_psum(shard, pod, err_shard)
        new_err = all_gather_stacked(new_err_shard, intra).reshape(-1)[:err.numel()].reshape(err.shape).to(err.dtype)
    else:
        dist.all_reduce(shard, group=pod)
        new_err = err

    # 3) all-gather intra-pod
    full = all_gather_stacked(shard, intra)              # [n_intra, piece]
    out = full.reshape(-1)[:g.numel()].reshape(g.shape)
    return out / (n_intra * n_pod), new_err


def make_hierarchical_allreduce(mesh, *, compress: bool = False):
    """``reduce_tree(grads, errs) -> (means, new_errs)``: the all-reduce-mean
    over ("pod", "data") of every leaf of a name -> tensor dict of gradients
    replicated over those dims, with one error-feedback state per leaf."""

    def reduce_tree(grads: Dict[str, torch.Tensor], errs: Dict[str, torch.Tensor]):
        outs, new_errs = {}, {}
        for k, g in grads.items():
            outs[k], ne = hierarchical_grad_reduce(g, mesh, compress=compress, err=errs[k])
            new_errs[k] = errs[k] if ne is None else ne
        return outs, new_errs

    return reduce_tree


def inter_pod_bytes_per_step(num_params: int, *, bytes_per_el: int = 2,
                             compress: bool = False, pods: int = 2) -> float:
    """Analytic bytes crossing the OTN per training step under the
    hierarchical exchange: each pod ships its scattered gradient once per
    peer direction, (pods-1)/pods * P elements out per pod, both ways."""
    per_el = bytes_per_el * (0.5 if compress else 1.0)
    return num_params * per_el * (pods - 1) / pods * 2.0
