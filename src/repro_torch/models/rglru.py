"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
port of ``repro.models.rglru``.

Recurrence (diagonal, per channel):
    r_t = sigmoid(x_t @ W_a + b_a)            recurrence gate
    i_t = sigmoid(x_t @ W_i + b_i)            input gate
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Full block: x -> {linear -> conv1d -> RG-LRU} gated by {linear -> GeLU},
then output linear. The gate projections are dense, as in the JAX package
(Griffin's are block-diagonal). Train and prefill send the recurrence
through ``kernels.ops.rglru_recurrence`` (the Hopper kernel on the card, the
step-by-step ``rglru_ref`` on the CPU; its backward is the reverse
recurrence through the same op), where the JAX model path runs
``jax.lax.associative_scan``. Decode is plain PyTorch, as there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.kernels.ops import rglru_recurrence
from repro_torch.models.layers import as_f32, conv_window, normal_
from repro_torch.parallel.tensor import (
    copy_to_model, gather_from_model, reduce_from_model, split_of, weight,
)

RglruCache = dict  # {"conv": [B, K-1, W] act dtype, "h": [B, W] f32}

_C = 8.0
_SQRT_EPS = 1e-6


def _gates(p: "RGLRU", x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., W] (post-conv). Returns (log_a, gated input) in f32.

    Split over "model", x is this rank's slice of the width and w_a, w_i
    are split on their output dim only: the gates read the whole width,
    gathered over "model" (its gradient summed back over "model")."""
    xf = x.float()
    tp = split_of(p)
    xg = xf if tp is None else copy_to_model(gather_from_model(xf, -1, tp), tp)
    r = torch.sigmoid(xg @ as_f32(p, "w_a", weight(p, "w_a")) + p.b_a)
    i = torch.sigmoid(xg @ as_f32(p, "w_i", weight(p, "w_i")) + p.b_i)
    log_a = -_C * F.softplus(p.lam) * r                       # [..., W] <= 0
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=_SQRT_EPS))
    return log_a, beta * (i * xf)


def rglru_scan(p: "RGLRU", x: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence mode. x: [B, S, W] (post-conv). Returns (h [B,S,W] in x's
    dtype, h_last [B,W] f32)."""
    log_a, b = _gates(p, x)
    a = torch.exp(log_a)
    if h0 is not None:
        # fold the initial state into the first step: h_1 = a_1 h_0 + b_1
        b[:, 0] += a[:, 0] * h0.float()
    h = rglru_recurrence(a, b)
    return h.to(x.dtype), h[:, -1].clone()   # not a view that keeps all of h


def rglru_step(p: "RGLRU", x_t: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One decode step. x_t: [B, W] (post-conv); h: [B, W] f32."""
    log_a, b = _gates(p, x_t)
    return torch.exp(log_a) * h.float() + b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: x [B,S,W], w [K,W]; the K-tap shifted
    sum in x's dtype, then the bias, in the JAX package's order."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(k)) + b[None, None, :]


class RGLRU(nn.Module):
    """The RG-LRU block, with the JAX package's parameter names.

    ``b_a``, ``b_i`` and ``lam`` are f32 whatever ``param_dtype`` is. Prefill
    returns a new cache; decode updates the cache it is given in place.

    Split over "model" (``rglru_shardable``), a rank computes its slice of
    the width: w_x and w_gate are column-parallel, the conv, lam, b_a and
    b_i are its slices, w_a and w_i their output columns (``_gates``), w_out
    is row-parallel. Serving, the cache stays whole over "model" (the rules'
    ``cache_spec``): a rank steps its width's part of the state and conv
    window, and the new parts are gathered over "model".
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru_width or d
        pd = dtype_of(cfg.param_dtype)

        def param(*shape, dtype=pd):
            return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))

        self.cfg = cfg
        self.w_x, self.w_gate = param(d, w), param(d, w)
        self.conv_w, self.conv_b = param(cfg.rglru_conv, w), param(w)
        self.w_a, self.b_a = param(w, w), param(w, dtype=torch.float32)
        self.w_i, self.b_i = param(w, w), param(w, dtype=torch.float32)
        self.lam = param(w, dtype=torch.float32)
        self.w_out = param(w, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: random leaves from its distributions, the rest exactly."""
        d, w = self.w_x.shape
        normal_(self.w_x, d ** -0.5, generator)
        normal_(self.w_gate, d ** -0.5, generator)
        normal_(self.conv_w, 0.1, generator)
        for m in (self.w_a, self.w_i, self.w_out):
            normal_(m, w ** -0.5, generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.b_a.zero_()
            self.b_i.zero_()
            # Lambda so that a ~ U(0.9, 0.999) at r = 1; in f64, rounded once
            a = torch.linspace(0.9, 0.999, w, dtype=torch.float64)
            self.lam.copy_(torch.log(torch.expm1(-torch.log(a) / _C)).float())

    def forward(self, x: torch.Tensor, *, mode: str, cache: Optional[RglruCache] = None
                ) -> Tuple[torch.Tensor, RglruCache]:
        tp = split_of(self)
        xc = copy_to_model(x, tp)
        gate = F.gelu(xc @ weight(self, "w_gate"), approximate="tanh")  # jax.nn.gelu's default
        xr = xc @ weight(self, "w_x")
        if mode == "decode":
            # cache: the last K-1 conv inputs and the f32 state, updated in
            # place here, where the JAX package returns new arrays. Split, a
            # rank steps its width's part and the new parts are gathered over
            # "model" into the whole cache, the rules' layout.
            conv, h = cache["conv"], cache["h"]
            if tp is not None:
                conv = conv.narrow(-1, *tp.part(conv.shape[-1]))
                h = h.narrow(-1, *tp.part(h.shape[-1]))
            window = torch.cat([conv, xr[:, :1]], dim=1)
            conv_out = (torch.einsum("bkw,kw->bw", window.float(), self.conv_w.float())
                        + self.conv_b.float()).to(x.dtype)
            h_new = rglru_step(self, conv_out, h)
            y = h_new.to(x.dtype)[:, None, :]
            cache["conv"].copy_(gather_from_model(window[:, 1:], -1, tp))
            cache["h"].copy_(gather_from_model(h_new, -1, tp))
        elif mode in ("train", "prefill"):
            y, h_last = rglru_scan(self, _causal_conv(xr, self.conv_w, self.conv_b))
            cache = None if mode == "train" else {
                "conv": gather_from_model(conv_window(xr, self.cfg.rglru_conv - 1), -1, tp),
                "h": gather_from_model(h_last, -1, tp)}
        else:
            raise ValueError(f"unknown mode {mode!r}; expected train, prefill or decode")
        return reduce_from_model((y * gate) @ weight(self, "w_out"), tp), cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> RglruCache:
    """A zeroed RG-LRU cache: the conv window in ``dtype``, the state in f32."""
    w = cfg.rglru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.rglru_conv - 1, w), dtype=dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}
