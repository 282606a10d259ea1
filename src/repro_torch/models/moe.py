"""Top-k token-choice Mixture-of-Experts with capacity dispatch: the port of
``repro.models.moe``.

Routing in f32: softmax router -> top-k -> gates renormalised over the k ->
each (token, slot) takes the next free position of its expert, in the flat
token-major [T*k] order, and is dropped past the expert's capacity
C = max(int(moe_capacity_factor * T * k / E), k), with T the tokens of this
call (B*S in a prefill or a training step, B in a decode step) -> the kept
tokens are scattered into per-expert buffers [E, C, d] -> batched SwiGLU
experts -> gathered back and weighted by the gates. A dropped slot adds 0:
the residual stream carries its token through (GShard / Switch semantics).

The scatter writes into [E, C+1, d], whose last row is a drop bin that is
cut off: kept slots are unique (an expert takes one token per position), so
only the discarded bin ever sums several rows, and the result does not
depend on the order of the accumulation. An expert appears at most once in
a token's top k, so a slot's position depends only on the set of experts of
the tokens before it, not on the order ``torch.topk`` gives ties.

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

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.models.layers import normal_
from repro_torch.parallel.collectives import all_reduce_sum, gather_rows
from repro_torch.parallel.sharding import batch_dims, get_ambient_mesh

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
               w_up: torch.Tensor, w_down: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Aux]:
    """xt [T, d] flat tokens -> (y [T, d] in xt's dtype, aux f32 scalars)."""
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
    slot = torch.where(keep, pos, cap).long()                      # cap: the drop bin

    # dispatch into [E, C+1, d], the last row the drop bin
    buf = xt.new_zeros((e, cap + 1, d)).index_put(
        (flat_e, slot), xt.repeat_interleave(k, dim=0), accumulate=True)[:, :cap]
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)      # [E, C, f]
    out = torch.bmm(h, w_down)                                     # [E, C, d]

    # combine: gather back, weight by the gates, dropped slots 0
    out = torch.cat([out, out.new_zeros((e, 1, d))], dim=1)
    w = (gates.reshape(-1) * keep.float()).to(out.dtype)
    y = (out[flat_e, slot] * w[:, None]).reshape(t, k, d).sum(dim=1)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y, aux


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
        global dispatch, and the rank keeps its own rows' outputs."""
        mesh = get_ambient_mesh()
        dims = batch_dims(mesh)
        weights = (self.router, self.w_gate, self.w_up, self.w_down)
        if dims and x.dim() == 3:
            b, s, d = x.shape
            if self.cfg.moe_group_by_batch:
                y, aux = moe_tokens(x.reshape(b * s, d), *weights, self.cfg)
                return y.reshape(b, s, d), {k: _mean_over(v, mesh, dims)
                                            for k, v in aux.items()}
            xs = _gather_rows(x, mesh, dims)
            y, aux = moe_tokens(xs.reshape(-1, d), *weights, self.cfg)
            r = _row_block(mesh, dims)
            return y.reshape(xs.shape)[r * b:(r + 1) * b], aux
        if self.cfg.moe_group_by_batch and x.dim() == 3:
            rows = [moe_tokens(row, *weights, self.cfg) for row in x]
            return (torch.stack([y for y, _ in rows]),
                    {key: torch.stack([a[key] for _, a in rows]).mean() for key in AUX_KEYS})
        y, aux = moe_tokens(x.reshape(-1, x.shape[-1]), *weights, self.cfg)
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
