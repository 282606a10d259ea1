"""Top-k token-choice Mixture-of-Experts with capacity dispatch: the port of
``repro.models.moe``.

Routing in f32: softmax router -> top-k -> gates renormalised over the k ->
each (token, slot) takes the next free position of its expert, in the flat
token-major [T*k] order, and is dropped past the expert's capacity
C = max(int(moe_capacity_factor * T * k / E), k), with T the tokens of this
call (B*S in a prefill or a training step, B in a decode step) -> the kept
tokens are gathered into per-expert buffers [E, C, d] -> batched SwiGLU
experts -> each token sums its slots' outputs weighted by the gates. A
dropped slot adds 0: the residual stream carries its token through (GShard /
Switch semantics).

Each expert's buffer has one row more, [E, C+1, d], kept zero: a dropped
slot reads it back. Kept slots are unique (an expert takes one token per
position), so each buffer row is one token's copy and each output row one
slot's; a token's k slots are summed in slot order, forward and backward,
never by an accumulating scatter, so a step repeats bit for bit. An expert
appears at most once in a token's top k, so a slot's position depends only
on the set of experts of the tokens before it, not on the order
``torch.topk`` gives ties.

The JAX package computes the scatter, the gather and the expert products
outside any Pallas kernel; here they are PyTorch ops on every device.
``capacity``, ``route`` and ``slots`` are module functions, looked up at
each call.

With ``moe_group_by_batch`` each row of a [B, S, d] input is routed alone
(capacity per row) and the aux values are averaged over the rows: what the
JAX package runs on one device without a mesh. Under a mesh (``forward``)
each rank routes its own rows as flat tokens, as the JAX package's
``shard_map`` over the batch axes does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.models.layers import normal_
from repro_torch.parallel.collectives import all_reduce_sum, gather_rows
from repro_torch.parallel.sharding import batch_dims, get_ambient_mesh
from repro_torch.parallel.tensor import (
    Split, copy_to_model, reduce_from_model, split_of, weight,
)

Aux = Dict[str, torch.Tensor]
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a call of ``tokens`` tokens (the JAX expression)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    return max(int(cfg.moe_capacity_factor * tokens * k / e), k)


def route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs [T, E], gates [T, k] renormalised over the top k, expert ids [T, k])."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx


def slots(flat_e: torch.Tensor, e: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(position of each slot of the flat token-major [T*k] expert ids in its
    expert: the slots before it there; whether it is kept, position < cap).

    The one-hot is laid out [E, T*k], so that the exclusive cumsum runs along
    its contiguous last dim: along the first dim of [T*k, E], CUDA's scan
    over an outer dim took 271 of granite-moe-1b-a400m's 413 ms of prefill
    kernel time on an H100 (B=4, S=2048)."""
    ids = torch.arange(e, device=flat_e.device)[:, None]
    onehot = (ids == flat_e[None, :]).to(torch.int32)              # [E, T*k]
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(before, 0, flat_e[None, :])[0]
    return pos, pos < cap


def moe_tokens(xt: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, cfg: ModelConfig,
               tp: Optional[Split] = None) -> Tuple[torch.Tensor, Aux]:
    """xt [T, d] flat tokens -> (y [T, d] in xt's dtype, aux f32 scalars).

    With ``tp`` the experts are split over "model" (``experts_shardable``):
    the routing is the same on every rank, each rank runs the experts of its
    E/M slice of the dispatch on its expert weights, and the combine sums
    the ranks' outputs over "model"."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(cfg, t)

    logits = xt.float() @ router                                   # [T, E] f32
    probs, gates, idx = route(logits, k)

    # load balance E * sum_e f_e p_e (f_e: the share of all T*k slots routed
    # to e, each adding 1/(T*k) as JAX's scatter-add does) and router z-loss
    flat_e = idx.reshape(-1)                                       # [T*k]
    share = torch.zeros(e, dtype=torch.float32, device=xt.device).index_add_(
        0, flat_e, torch.full((t * k,), 1.0 / (t * k), device=xt.device))
    lb_loss = e * torch.sum(share * probs.mean(dim=0))
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    pos, keep = slots(flat_e, e, cap)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return _experts(xt, gates, flat_e, pos, keep, cap, w_gate, w_up, w_down, tp), aux


def _experts(xt, gates, flat_e, pos, keep, cap, w_gate, w_up, w_down, tp: Optional[Split]):
    """``moe_tokens``' dispatch, experts and combine on this rank's experts
    (all of them without ``tp``).

    Each of the rank's buffer rows [E/M, C+1] is told which (token, slot)
    pair it holds (an int scatter); the last row of an expert holds none and
    stays zero. The rank copies only those pairs' tokens into the buffer,
    about T*k/M rows, and each token's output sums its k slots' rows of the
    gate-weighted expert output (a dropped slot, or another rank's expert,
    reads a zero row). So no [T*k, d] tensor exists."""
    t, d = xt.shape
    k = gates.shape[-1]
    n = w_gate.shape[0]
    first = tp.rank * n if tp is not None else 0
    local_e = flat_e - first
    mine = keep & (local_e >= 0) & (local_e < n)
    at = torch.where(mine, local_e * (cap + 1) + pos, cap)         # [T*k]; cap: a zero row
    pair = torch.full((n * (cap + 1),), t * k, dtype=torch.long, device=xt.device)
    pair.scatter_(0, at, torch.arange(t * k, device=xt.device))
    pair.view(n, cap + 1)[:, cap] = t * k                          # only dropped pairs went there
    full = pair < t * k
    tok, at = torch.where(full, pair // k, 0), at.view(t, k)
    buf = _Dispatch.apply(copy_to_model(xt, tp), tok, full, at).view(n, cap + 1, d)
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)      # [E/M, C+1, f]
    out = torch.bmm(h, w_down).view(-1, d)                         # [E/M * (C+1), d]
    g = copy_to_model(gates, tp).reshape(-1)[pair.clamp(max=t * k - 1)]
    out = out * torch.where(full, g, 0).to(out.dtype)[:, None]
    return reduce_from_model(_Combine.apply(out, tok, full, at), tp)


def _sum_slots(rows: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """rows [R, d] -> [T, d]: each token's rows ``at`` [T, k] summed in slot
    order, in f32, cast back to ``rows``' dtype."""
    y = rows[at[:, 0]].float()
    for j in range(1, at.shape[1]):
        y = y + rows[at[:, j]]
    return y.to(rows.dtype)


class _Dispatch(torch.autograd.Function):
    """x [T, d] -> buffer rows [R, d], row r token ``tok[r]`` where
    ``full[r]``, else zeros. The backward sums each token's slot rows
    (``_sum_slots``) rather than scatter-adding them, whose order varies
    between runs where the adds are atomic; so do ``_Combine``'s two
    directions, the adjoints of these."""

    @staticmethod
    def forward(ctx, x, tok, full, at):
        ctx.save_for_backward(full, at)
        return x[tok].masked_fill_(~full[:, None], 0)

    @staticmethod
    def backward(ctx, g):
        full, at = ctx.saved_tensors
        return _sum_slots(g.masked_fill(~full[:, None], 0), at), None, None, None


class _Combine(torch.autograd.Function):
    """rows [R, d] -> y [T, d], ``_sum_slots``; the backward gives row r
    token ``tok[r]``'s gradient where ``full[r]`` (a zero row takes none)."""

    @staticmethod
    def forward(ctx, rows, tok, full, at):
        ctx.save_for_backward(tok, full)
        return _sum_slots(rows, at)

    @staticmethod
    def backward(ctx, g):
        tok, full = ctx.saved_tensors
        return g[tok].masked_fill_(~full[:, None], 0), None, None, None


def aux_zero(device=None) -> Aux:
    return {key: torch.zeros((), dtype=torch.float32, device=device) for key in AUX_KEYS}


class MoE(nn.Module):
    """Router [d, E] f32; experts w_gate, w_up [E, d, f] and w_down [E, f, d]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        pd = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, dtype=pd, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, f, dtype=pd, device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, d, dtype=pd, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff
        normal_(self.router, d ** -0.5, generator)
        normal_(self.w_gate, d ** -0.5, generator)
        normal_(self.w_up, d ** -0.5, generator)
        normal_(self.w_down, f ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Aux]:
        """x [..., d] -> (y of x's shape, aux).

        Under an ambient mesh with batch dims (``parallel.use_mesh``), a
        [B, S, d] ``x`` is this rank's rows of a batch split over those dims:
        with ``moe_group_by_batch`` the rank
        routes its rows as flat tokens and the aux values are averaged over
        the batch dims (the JAX package's ``shard_map`` over them; the expert
        weights are replicated there); without it every rank's rows are
        gathered and routed together, as GSPMD partitions the JAX package's
        global dispatch, and the rank keeps its own rows' outputs; with the
        experts split over "model" each rank runs its own (``moe_tokens``)."""
        mesh = get_ambient_mesh()
        dims = batch_dims(mesh)
        weights = tuple(weight(self, n) for n in ("router", "w_gate", "w_up", "w_down"))
        if dims and x.dim() == 3:
            b, s, d = x.shape
            if self.cfg.moe_group_by_batch:
                y, aux = moe_tokens(x.reshape(b * s, d), *weights, self.cfg)
                return y.reshape(b, s, d), {k: _mean_over(v, mesh, dims)
                                            for k, v in aux.items()}
            xs = _gather_rows(x, mesh, dims)
            y, aux = moe_tokens(xs.reshape(-1, d), *weights, self.cfg, split_of(self))
            r = _row_block(mesh, dims)
            return y.reshape(xs.shape)[r * b:(r + 1) * b], aux
        if self.cfg.moe_group_by_batch and x.dim() == 3:
            rows = [moe_tokens(row, *weights, self.cfg) for row in x]
            return (torch.stack([y for y, _ in rows]),
                    {key: torch.stack([a[key] for _, a in rows]).mean() for key in AUX_KEYS})
        y, aux = moe_tokens(x.reshape(-1, x.shape[-1]), *weights, self.cfg, split_of(self))
        return y.reshape(x.shape), aux


def _row_block(mesh, dims: tuple) -> int:
    """This rank's block of rows along the batch dims (major to minor)."""
    r = 0
    for name in dims:
        r = r * mesh.size(mesh.mesh_dim_names.index(name)) + mesh.get_local_rank(name)
    return r


def _gather_rows(x: torch.Tensor, mesh, dims: tuple) -> torch.Tensor:
    """Every rank's rows in batch order (an all-gather over each batch dim,
    minor first; its backward reduce-scatters the gradients)."""
    for name in reversed(dims):
        x = gather_rows(x, mesh.get_group(name))
    return x


def _mean_over(v: torch.Tensor, mesh, dims: tuple) -> torch.Tensor:
    """The mean of ``v`` over the batch dims' ranks (differentiable)."""
    n = 1
    for name in dims:
        v = all_reduce_sum(v, mesh.get_group(name))
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return v / n
