"""Plain reference of the ``ssm`` family: Mamba2 blocks (arXiv:2405.21060).

Each layer: x + out_proj(gated_rmsnorm(SSD(conv(in_proj(rmsnorm(x)))), z)).
The in-projection gives z, x, B and C (one group) and dt; x, B and C each
pass a causal depthwise convolution and SiLU; dt = softplus(dt_raw +
dt_bias); A = -exp(A_log). The SSD is written in its quadratic (dual) form
over the whole sequence, y_t = sum_{j<=t} (C_t . B_j) exp(sum_{k=j+1..t}
dt_k A) dt_j x_j + D x_t, with the decay's cumulative sums in float64 so
that no long sequence loses them to cancellation. No chunks, no state
carried: the program's chunked scan and its recurrent decode must both
agree with it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.reference.common import Params, linear, rmsnorm, silu


def dims(cfg: dict) -> Tuple[int, int, int, int]:
    """(d_inner, heads, headdim, state)."""
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    return d_in, d_in // cfg["ssm_headdim"], cfg["ssm_headdim"], cfg["ssm_state"]


def param_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init, std) of every parameter, in the order the
    weights are drawn; init is normal (std), ones, zeros, a_log or dt_bias."""
    d, v, k = cfg["d_model"], cfg["vocab_size"], cfg["ssm_conv"]
    d_in, h, _, n = dims(cfg)
    out = [("embed.tok", (v, d), "normal", 0.02)]
    for i in range(cfg["num_layers"]):
        p = f"backbone.layers.{i}."
        s = p + "ssd."
        out += [(p + "norm1.scale", (d,), "ones", 0.0),
                (s + "w_z", (d, d_in), "normal", d ** -0.5),
                (s + "w_x", (d, d_in), "normal", d ** -0.5),
                (s + "w_bc", (d, 2 * n), "normal", d ** -0.5),
                (s + "w_dt", (d, h), "normal", d ** -0.5),
                (s + "conv_x_w", (k, d_in), "normal", 0.1),
                (s + "conv_x_b", (d_in,), "zeros", 0.0),
                (s + "conv_bc_w", (k, 2 * n), "normal", 0.1),
                (s + "conv_bc_b", (2 * n,), "zeros", 0.0),
                (s + "A_log", (h,), "a_log", 0.0),
                (s + "D", (h,), "ones", 0.0),
                (s + "dt_bias", (h,), "dt_bias", 0.0),
                (s + "norm_scale", (d_in,), "ones", 0.0),
                (s + "w_out", (d_in, d), "normal", d_in ** -0.5)]
    out.append(("backbone.final_norm.scale", (d,), "ones", 0.0))
    return out


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over the sequence: x [B, S, C], w [K, C];
    out_t = b + sum_i w_i x_{t-K+1+i} (zeros before the start)."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return b.float() + sum(pad[:, i:i + s] * w[i].float() for i in range(k))


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
        cm: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, P], dt [B, S, H], a [H] (negative), bm, cm [B, S, N] ->
    y [B, S, H, P], the quadratic form from a zero state."""
    s = x.shape[1]
    cs = torch.cumsum((dt * a).double(), dim=1).transpose(1, 2)        # [B, H, S]
    seg = (cs[..., :, None] - cs[..., None, :]).float()                 # [B, H, t, j]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    del seg
    cb = torch.einsum("btn,bjn->btj", cm, bm)                           # [B, t, j]
    xdt = (x * dt[..., None]).transpose(1, 2)                           # [B, H, j, P]
    return torch.matmul(decay * cb[:, None], xdt).transpose(1, 2)


def block(cfg: dict, params: Params, i: int, x: torch.Tensor, prec: str,
          groups: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = f"backbone.layers.{i}."
    s = p + "ssd."
    d_in, nh, hp, n = dims(cfg)
    b, t, _ = x.shape
    h = rmsnorm(x, params[p + "norm1.scale"], cfg["norm_eps"])
    z = linear(h, params[s + "w_z"], prec)
    xr = linear(h, params[s + "w_x"], prec)
    bc = linear(h, params[s + "w_bc"], prec)
    dt_raw = linear(h, params[s + "w_dt"], prec)
    xc = silu(causal_conv(xr, params[s + "conv_x_w"], params[s + "conv_x_b"]))
    bcc = silu(causal_conv(bc, params[s + "conv_bc_w"], params[s + "conv_bc_b"]))
    dt = F.softplus(dt_raw + params[s + "dt_bias"].float())
    a = -torch.exp(params[s + "A_log"].float())
    xh = xc.reshape(b, t, nh, hp)
    y = ssd(xh, dt, a, bcc[..., :n], bcc[..., n:]) + params[s + "D"].float()[:, None] * xh
    g = y.reshape(b, t, d_in) * silu(z)
    g = rmsnorm(g, params[s + "norm_scale"], cfg["gated_norm_eps"])
    return x + linear(g, params[s + "w_out"], prec), {}
