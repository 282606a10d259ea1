"""Plain reference of the ``moe`` family: pre-norm blocks of causal GQA
attention with rotary embeddings and a top-k mixture of SwiGLU experts.

Attention: q, k, v projections, rotary embeddings at positions 0.., scores
q.k / sqrt(head_dim) over the causal prefix, softmax, P.V, the output
projection; query head h reads kv head h // (heads / kv_heads).

The mixture, as the configuration states it: a float32 router, softmax, the
top k experts of each token with their probabilities renormalised over the
k, and a capacity of max(int(capacity_factor * T * k / E), k) tokens an
expert for a call of T tokens, filled in token-major order (token by token,
each token's slots in the order of its top k; a slot past its expert's
capacity is dropped and adds nothing). The load-balance term is E * sum_e
f_e p_e (f_e the share of the T * k slots routed to e, not differentiated;
p_e the mean router probability) and the z term the mean squared
log-sum-exp of the router logits, each summed over the layers.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from bench.reference.common import Params, linear, rmsnorm, rope, silu


def param_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init, std) of every parameter, in the order the
    weights are drawn."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    hq, hk, f, e = cfg["num_heads"], cfg["num_kv_heads"], cfg["d_ff"], cfg["num_experts"]
    hd = d // hq
    out = [("embed.tok", (v, d), "normal", 0.02)]
    for i in range(cfg["num_layers"]):
        p = f"backbone.layers.{i}."
        out += [(p + "norm1.scale", (d,), "ones", 0.0),
                (p + "attn.wq", (d, hq * hd), "normal", d ** -0.5),
                (p + "attn.wk", (d, hk * hd), "normal", d ** -0.5),
                (p + "attn.wv", (d, hk * hd), "normal", d ** -0.5),
                (p + "attn.wo", (hq * hd, d), "normal", (hq * hd) ** -0.5),
                (p + "norm2.scale", (d,), "ones", 0.0),
                (p + "moe.router", (d, e), "normal", d ** -0.5),
                (p + "moe.w_gate", (e, d, f), "normal", d ** -0.5),
                (p + "moe.w_up", (e, d, f), "normal", d ** -0.5),
                (p + "moe.w_down", (e, f, d), "normal", f ** -0.5)]
    out.append(("backbone.final_norm.scale", (d,), "ones", 0.0))
    return out


def attention(cfg: dict, params: Params, p: str, h: torch.Tensor, prec: str) -> torch.Tensor:
    b, s, d = h.shape
    hq, hk = cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // hq
    pos = torch.arange(s, device=h.device)
    q = rope(linear(h, params[p + "attn.wq"], prec).reshape(b, s, hq, hd), pos, cfg["rope_theta"])
    k = rope(linear(h, params[p + "attn.wk"], prec).reshape(b, s, hk, hd), pos, cfg["rope_theta"])
    v = linear(h, params[p + "attn.wv"], prec).reshape(b, s, hk, hd)
    k, v = (t.repeat_interleave(hq // hk, dim=2) for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hq * hd)
    return linear(o, params[p + "attn.wo"], prec)


def capacity(cfg: dict, tokens: int) -> int:
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    return max(int(cfg["moe_capacity_factor"] * tokens * k / e), k)


def mixture(cfg: dict, params: Params, p: str, xt: torch.Tensor, prec: str, cap: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mixture on tokens xt [T, d] in token-major order, ``cap`` slots
    an expert."""
    t, d = xt.shape
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    logits = linear(xt, params[p + "moe.router"], prec)                # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.topk(probs, k, dim=-1)
    gates = top / top.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    flat = idx.reshape(-1)                                              # token-major slots
    onehot = torch.nn.functional.one_hot(flat, e)                       # [T*k, E]
    before = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = before < cap
    y = torch.zeros_like(xt)
    wg, wu, wd = (params[p + "moe." + n] for n in ("w_gate", "w_up", "w_down"))
    for j in range(e):
        slot = torch.nonzero((flat == j) & kept)[:, 0]
        if slot.numel() == 0:
            continue
        tok = slot // k
        xe = xt[tok]
        he = silu(linear(xe, wg[j], prec)) * linear(xe, wu[j], prec)
        y = y.index_add(0, tok, linear(he, wd[j], prec) * gates.reshape(-1)[slot][:, None])
    share = torch.bincount(flat, minlength=e).float() / flat.numel()
    aux = {"lb": e * torch.sum(share * probs.mean(dim=0)),
           "z": torch.mean(torch.logsumexp(logits, dim=-1).square()),
           "dropped": (~kept).float().mean().detach()}
    return y, aux


def block(cfg: dict, params: Params, i: int, x: torch.Tensor, prec: str,
          groups: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = f"backbone.layers.{i}."
    x = x + attention(cfg, params, p, rmsnorm(x, params[p + "norm1.scale"], cfg["norm_eps"]),
                      prec)
    h = rmsnorm(x, params[p + "norm2.scale"], cfg["norm_eps"])
    b, _, d = h.shape
    outs, aux = [], {}
    for (a, z), cap in _calls(cfg, groups, b):
        y, one = mixture(cfg, params, p, h[:, a:z].reshape(-1, d), prec, cap)
        outs.append(y.reshape(b, z - a, d))
        aux = one if not aux else {key: aux[key] + one[key] for key in aux}
    return x + torch.cat(outs, dim=1), aux


def _calls(cfg: dict, groups: Sequence[Tuple[int, int]], rows: int) -> list:
    """((a, b), capacity) of each call: the groups whose capacity holds all
    their tokens (no slot can drop: a token takes an expert once) merged
    where they follow one another, since then no token's result depends on
    the others of its call. Such a merged call's aux terms are not the
    groups' (the serving reference reads none)."""
    out = []
    for a, z in groups:
        t = rows * (z - a)
        cap = capacity(cfg, t)
        if cap >= t and out and out[-1][1] is None and out[-1][0][1] == a:
            out[-1] = ((out[-1][0][0], z), None)
        else:
            out.append(((a, z), None if cap >= t else cap))
    return [((a, z), cap if cap is not None else rows * (z - a)) for (a, z), cap in out]
