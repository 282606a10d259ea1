"""Mamba2 (SSD, state-space duality) block: the port of ``repro.models.ssm``.

The chunked SSD algorithm of arXiv:2405.21060 (``ssd_chunked``), its
one-token recurrent step (``ssd_decode_step``) and the block around them
(in_proj -> causal conv -> SSD -> gated RMSNorm -> out_proj).

Shapes (h = heads, p = headdim, n = state, g = groups (=1 here)):
  x   [B, S, h, p]     dt [B, S, h]     A [h] (negative)
  B,C [B, S, g, n]
  state H [B, h, n, p]

Train and prefill send the scan through ``kernels.ops.ssd_scan`` (the Hopper
kernel on the card, ``ssd_chunked`` in f32 on the CPU; its backward is the
gradient of a recompute through ``ssd_chunked``). Decode is plain PyTorch:
the JAX package has no kernel there either.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.kernels.ops import ssd_scan
from repro_torch.models.layers import conv_window, normal_
from repro_torch.parallel.tensor import (
    copy_to_model, gather_from_model, reduce_from_model, scatter_to_model, split_of,
    sum_over_model, weight,
)

SsdCache = dict  # {"conv_x" [B,K-1,d_in], "conv_bc" [B,K-1,2gn], "ssm" [B,h,n,p] f32}

GATED_NORM_EPS = 1e-5   # mamba2's RMSNormGated, whatever cfg.norm_eps is


# ---------------------------------------------------------------------------
# Core SSD scan
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., T] -> [..., T, T]: out[i,j] = sum_{k=j+1..i} x_k (i>=j), -inf else."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, float("-inf"))


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Appends ``pad`` zero steps along dim 1."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))], dim=1)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, *, chunk: int, init_state: Optional[torch.Tensor] = None,
                round_to: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,h,p] in x's dtype, final_state [B,h,n,p] f32). Decays in f32.

    As in the JAX package, ``x * dt`` and ``C B^T * L`` are rounded to x's
    dtype before the intra-chunk product; in f32 that rounds nothing. With
    ``round_to`` they are also rounded to that dtype there (only there: the
    per-chunk states take ``x * dt`` in x's dtype), as the bf16 SSD kernel
    rounds them.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    chunk = min(chunk, s)
    if s % chunk:
        # pad tail with dt=0 steps: exp(0*A)=1 and dt*B(x)x=0 leave the state
        # invariant, so the final state is exact; padded outputs are sliced off.
        pad = chunk - s % chunk
        y, fin = ssd_chunked(_pad_seq(x, pad), _pad_seq(dt, pad), A, _pad_seq(B, pad),
                             _pad_seq(C, pad), chunk=chunk, init_state=init_state,
                             round_to=round_to)
        return y[:, :s], fin
    nc = s // chunk
    rep = h // g

    dtf = dt.float()
    dA = dtf * A.float()[None, None, :]                       # [b,s,h] (<0)
    xdt = x * dt[..., None].to(x.dtype)                       # input scaled by dt

    xc = xdt.reshape(b, nc, chunk, h, p)
    Bh = B.repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n).float()
    Ch = C.repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n).float()
    dAc = dA.reshape(b, nc, chunk, h)
    dAcs = torch.cumsum(dAc, dim=2)                           # [b,c,l,h]

    # 1) intra-chunk (quadratic within chunk)
    L = torch.exp(_segsum(dAc.movedim(3, 2)))                 # [b,c,h,l,l]
    Sqk = torch.einsum("bclhn,bckhn->bchlk", Ch, Bh)
    p_mat, xd = (Sqk * L).to(x.dtype), xc
    if round_to is not None:
        p_mat, xd = p_mat.to(round_to).to(x.dtype), xc.to(round_to).to(x.dtype)
    y_diag = torch.einsum("bchlk,bckhp->bclhp", p_mat, xd)

    # 2) per-chunk terminal states
    decay_to_end = torch.exp(dAcs[:, :, -1:, :] - dAcs)       # [b,c,l,h]
    states = torch.einsum("bclhn,bclhp->bchnp", Bh * decay_to_end[..., None],
                          xc.float())                         # [b,c,h,n,p]

    # 3) inter-chunk recurrence (f32 carry); h_prev[c] is the state entering chunk c
    lam = torch.exp(dAcs[:, :, -1, :])                        # [b,c,h] chunk decay
    carry = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * lam[:, c, :, None, None] + states[:, c]

    # 4) inter-chunk contribution to outputs
    y_off = torch.einsum("bclhn,bchnp->bclhp", Ch * torch.exp(dAcs)[..., None],
                         torch.stack(h_prev, dim=1))
    y = (y_diag.float() + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                    A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: H <- H*exp(dt*A) + dt*B(x)x ; y = C.H.

    state [B,h,n,p] f32; x_t [B,h,p]; dt_t [B,h]; A [h]; B_t, C_t [B,g,n].
    Returns (new state f32, y [B,h,p] in x_t's dtype)."""
    h = state.shape[1]
    rep = h // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1).float()            # [B,h,n]
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    dtf = dt_t.float()
    dA = torch.exp(dtf * A.float()[None, :])                  # [B,h]
    upd = (dtf[..., None] * Bh)[..., :, None] * x_t.float()[:, :, None, :]
    new_state = state * dA[..., None, None] + upd             # [B,h,n,p]
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return new_state, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def ssd_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, groups)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_headdim, 1


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq, then SiLU: xbc [B,S,Ch], w [K,Ch].

    The K-tap shifted sum in the input's dtype, as the JAX package writes it
    (an f32 ``F.conv1d`` on the card would go through cuDNN in TF32)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b[None, None, :])


def _gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, tp=None
                    ) -> torch.Tensor:
    """mamba2's RMSNormGated, norm(y * silu(z)), in f32, cast back to y's dtype.

    With ``tp`` y, z and scale are this rank's slice of d_inner: the mean of
    squares is over the whole d_inner, its sum reduced over "model"."""
    gated = (y * F.silu(z.float()).to(y.dtype)).float()
    if tp is None:
        ms = gated.square().mean(dim=-1, keepdim=True)
    else:
        ms = sum_over_model(gated.square().sum(dim=-1, keepdim=True), tp) / (
            gated.shape[-1] * tp.size)
    out = gated * torch.rsqrt(ms + GATED_NORM_EPS)
    return (out * scale.float()).to(y.dtype)



class SSD(nn.Module):
    """The Mamba2 mixer, with the JAX package's parameter names.

    Projections are separate (w_z, w_x, w_bc, w_dt) as there; ``A_log``,
    ``D`` and ``dt_bias`` are f32 whatever ``param_dtype`` is. Prefill
    returns a new cache; decode updates the cache it is given in place.

    Split over "model" (``ssd_shardable``), a rank computes its heads: w_z,
    w_x (column-parallel), conv_x, A_log, D, dt_bias and the norm's scale
    are its slices; w_bc, w_dt and conv_bc are whole (B and C feed every
    head; the rank takes its heads of dt); the gated norm's mean of squares
    is summed over "model"; w_out is row-parallel. Serving, the cache
    stays whole over "model" (the rules' ``cache_spec``): prefill gathers
    the heads' final states and conv_x's channels, and decode steps the
    rank's part and gathers the new parts.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, nheads, g = ssd_dims(cfg)
        bc = 2 * g * cfg.ssm_state
        pd = dtype_of(cfg.param_dtype)

        def param(*shape, dtype=pd):
            return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))

        self.cfg = cfg
        self.w_z, self.w_x = param(d, d_in), param(d, d_in)
        self.w_bc, self.w_dt = param(d, bc), param(d, nheads)
        self.conv_x_w, self.conv_x_b = param(cfg.ssm_conv, d_in), param(d_in)
        self.conv_bc_w, self.conv_bc_b = param(cfg.ssm_conv, bc), param(bc)
        self.A_log = param(nheads, dtype=torch.float32)
        self.D = param(nheads, dtype=torch.float32)
        self.dt_bias = param(nheads, dtype=torch.float32)
        self.norm_scale = param(d_in)
        self.w_out = param(d_in, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: random leaves from its distributions, the rest exactly."""
        d, d_in = self.w_z.shape
        nheads = self.A_log.shape[0]
        for w in (self.w_z, self.w_x, self.w_bc, self.w_dt):
            normal_(w, d ** -0.5, generator)
        normal_(self.conv_x_w, 0.1, generator)
        normal_(self.conv_bc_w, 0.1, generator)
        normal_(self.w_out, d_in ** -0.5, generator)
        lo, hi = torch.log(torch.tensor([1e-3, 1e-1], dtype=torch.float32)).tolist()
        u = torch.rand(nheads, generator=generator, device=generator.device) * (hi - lo) + lo
        with torch.no_grad():
            self.conv_x_b.zero_()
            self.conv_bc_b.zero_()
            # in f64, rounded once: within 1 ulp of JAX's f32 at 32 heads
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nheads,
                                                      dtype=torch.float64)).float())
            self.D.fill_(1.0)
            self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))  # inverse softplus
            self.norm_scale.fill_(1.0)

    def forward(self, x: torch.Tensor, *, mode: str, cache: Optional[SsdCache] = None
                ) -> Tuple[torch.Tensor, SsdCache]:
        cfg = self.cfg
        d_in, nheads, g = ssd_dims(cfg)
        n, hp = cfg.ssm_state, cfg.ssm_headdim
        b, s, _ = x.shape
        tp = split_of(self)
        xc = copy_to_model(x, tp)
        z, xr = xc @ weight(self, "w_z"), xc @ weight(self, "w_x")
        bc, dt_raw = x @ weight(self, "w_bc"), x @ weight(self, "w_dt")
        A = -torch.exp(self.A_log)
        if tp is not None:
            d_in, nheads = d_in // tp.size, nheads // tp.size
            dt_raw = scatter_to_model(dt_raw, -1, tp)

        if mode == "decode":
            # cache: the last K-1 conv inputs and the f32 state, updated in
            # place here, where the JAX package returns new arrays. Split, a
            # rank steps its heads' part of the whole state (and its channels
            # of conv_x), and the new parts are gathered over "model" into
            # the whole cache, the rules' layout.
            conv_x, state = cache["conv_x"], cache["ssm"]
            if tp is not None:
                conv_x = conv_x.narrow(-1, *tp.part(conv_x.shape[-1]))
                state = state.narrow(1, *tp.part(state.shape[1]))
            win_x = torch.cat([conv_x, xr[:, :1]], dim=1)
            win_bc = torch.cat([cache["conv_bc"], bc[:, :1]], dim=1)
            cx = F.silu(torch.einsum("bkc,kc->bc", win_x.float(), self.conv_x_w.float())
                        + self.conv_x_b.float()).to(x.dtype)
            cbc = F.silu(torch.einsum("bkc,kc->bc", win_bc.float(), self.conv_bc_w.float())
                         + self.conv_bc_b.float()).to(x.dtype)
            x_t = cx.reshape(b, nheads, hp)
            B_t, C_t = (t.reshape(b, g, n) for t in cbc.split(g * n, dim=-1))
            dt_t = F.softplus(dt_raw[:, 0].float() + self.dt_bias[None, :])
            new_state, y = ssd_decode_step(state, x_t, dt_t, A, B_t, C_t)
            y = y + self.D.float()[None, :, None] * x_t.float()
            y = y.reshape(b, 1, d_in).to(x.dtype)
            cache["conv_x"].copy_(gather_from_model(win_x[:, 1:], -1, tp))
            cache["conv_bc"].copy_(win_bc[:, 1:])
            cache["ssm"].copy_(gather_from_model(new_state, 1, tp))
        elif mode in ("train", "prefill"):
            cx = _causal_conv(xr, self.conv_x_w, self.conv_x_b)
            cbc = copy_to_model(_causal_conv(bc, self.conv_bc_w, self.conv_bc_b), tp)
            x_ = cx.reshape(b, s, nheads, hp)
            B_, C_ = (t.reshape(b, s, g, n) for t in cbc.split(g * n, dim=-1))
            dt = F.softplus(dt_raw.float() + self.dt_bias)
            y, final_state = ssd_scan(x_, dt, A, B_, C_, chunk=cfg.ssm_chunk)
            y = y.float() + self.D[None, None, :, None] * x_.float()
            y = y.reshape(b, s, d_in).to(x.dtype)
            k = cfg.ssm_conv
            cache = None if mode == "train" else {
                "conv_x": gather_from_model(conv_window(xr, k - 1), -1, tp),
                "conv_bc": conv_window(bc, k - 1),
                "ssm": gather_from_model(final_state, 1, tp)}
        else:
            raise ValueError(f"unknown mode {mode!r}; expected train, prefill or decode")
        return reduce_from_model(
            _gated_rms_norm(y, z, self.norm_scale, tp) @ weight(self, "w_out"), tp), cache


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device=None) -> SsdCache:
    """A zeroed SSD cache: conv windows in ``dtype``, the state in f32."""
    d_in, nheads, g = ssd_dims(cfg)
    k = cfg.ssm_conv - 1
    return {
        "conv_x": torch.zeros((batch, k, d_in), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, k, 2 * g * cfg.ssm_state), dtype=dtype,
                               device=device),
        "ssm": torch.zeros((batch, nheads, cfg.ssm_state, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
    }
