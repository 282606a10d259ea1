"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Direct formulations (materialised scores, step-by-step recurrences): slow,
obviously correct. The card's checks hold each kernel against them on the
same inputs. The CPU path of each op (``kernels.ops``) runs the version that
repeats what its kernel computes for that dtype: flash attention
``attention_tiled_ref`` in bf16 (the bf16 kernel's tiles and roundings) and
``attention_ref`` in f32; the SSD scan the chunked algorithm
(``ops.ssd_scan_plain``, with the bf16 kernel's roundings in bf16), since the
recurrence here is one step at a time; the RG-LRU scan
``rglru_chunked_ref``, the kernel's association. ``ssd_ref(round_to=,
chunk=)`` repeats the bf16 SSD kernel's roundings step by step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634   # the kernel's constant, an f32
FLASH_TILE = 64              # keys a tile of the bf16 flash kernel (TC_BK)
_F32_TINY = 2.0 ** -126      # below it ex2.approx.ftz returns 0


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  softcap: float = 0.0, window: int = 0,
                  p_dtype: Optional[torch.dtype] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive causal GQA attention. q [B,S,Hq,D]; k,v [B,S,Hk,D].

    Scores, softmax and P.V in f32; the output is cast to q's dtype. P is
    the softmax over the whole row: without ``p_dtype`` it stays f32 (the
    f32 kernel's arithmetic, and the TPU kernel's); with ``p_dtype`` the
    normalised P is rounded to that dtype before P.V, as the JAX model
    path's banded attention and decode round it. The bf16 kernel rounds
    neither: it rounds the unnormalised p of each key tile
    (``attention_tiled_ref``). ``scale`` multiplies the scores (default
    D^-0.5).
    """
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = q.reshape(b, s, hk, g, d)
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = i >= j
    if window:
        mask = mask & (i - j < window)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, s, hq, d).to(q.dtype)


def _exp2_ftz(x: torch.Tensor) -> torch.Tensor:
    """2^x in f32 with results under 2^-126 flushed to 0, as ex2.approx.ftz."""
    y = torch.exp2(x)
    return y.masked_fill(y < _F32_TINY, 0.0)


def attention_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """The bf16 flash kernel's arithmetic in plain PyTorch. q [B,S,Hq,D];
    k,v [B,S,Hk,D] (query head h reads kv head h // (Hq / Hk)).

    The keys are walked in tiles of FLASH_TILE, in order. Per tile the f32
    scores are multiplied by the scale D^-0.5 before the softcap; the causal
    mask and the window (query t attends keys [t-W+1, t]) set a masked score
    to -1e30 and its probability to exactly 0. The running max m and the
    rescale corr = 2^(m_old - m) stay in f32; p = 2^(x - m) is left
    unnormalised, rounded to q's dtype before P.V, and P.V accumulates in
    f32; l sums the f32 p. The output is acc / max(l, 1e-30), rounded once
    to q's dtype. The exponent is in log2 units, as the kernel's (the scale
    carries log2(e), or the softcap's output does), and results under
    2^-126 flush to 0, as its ex2.approx.ftz; its approximation itself (a
    few f32 ulps) is not repeated.

    The kernel skips a tile with no key in its rows' bands; a fully masked
    tile adds p = 0 and rescales by 1, so walking it here is exact.
    """
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    f32 = torch.float32
    unit = torch.tensor(LOG2E, dtype=f32)
    sc = torch.tensor(d ** -0.5, dtype=f32)
    qk_scale = sc if softcap > 0 else sc * unit
    cap = torch.tensor(softcap, dtype=f32)
    qg = q.reshape(b, s, hk, g, d).float()
    qpos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, hk, g, s), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, hk, g, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, hk, g, s, d), dtype=f32, device=q.device)
    for k0 in range(0, s, FLASH_TILE):
        kt, vt = k[:, k0:k0 + FLASH_TILE].float(), v[:, k0:k0 + FLASH_TILE].float()
        x = torch.einsum("bqhgd,bkhd->bhgqk", qg, kt) * qk_scale
        if softcap > 0:
            x = cap * torch.tanh(x / cap) * unit
        kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask = mask & (qpos - kpos < window)
        x = x.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, x.amax(dim=-1))
        corr = _exp2_ftz(m - m_new)
        p = _exp2_ftz(x - m_new[..., None]).masked_fill(~mask, 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                   p.to(q.dtype).float(), vt)
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]                  # [b,hk,g,s,d]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, init_state: Optional[torch.Tensor] = None, *,
            round_to: Optional[torch.dtype] = None, chunk: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step SSD recurrence (O(S) sequential), all in f32.

    x [b,s,h,p]; dt [b,s,h]; A [h] (<0); B,C [b,s,g,n]; init_state [b,h,n,p].
    h_t = h_{t-1} * exp(dt_t A) + dt_t * B_t (x) x_t ;  y_t = C_t . h_t
    Returns (y [b,s,h,p] in x's dtype, final state [b,h,n,p] f32).

    With ``round_to`` (and ``chunk``), y_t is split as the chunked scan
    splits it: the state entering t's chunk, decayed, read by C_t, plus the
    sum over the chunk's steps j <= t of C_t.B_j exp(cs_t - cs_j) and
    dt_j x_j, each of those two rounded to ``round_to`` first, as the bf16
    kernel and the JAX model path round them. The state stays in f32.
    """
    if round_to is not None and not chunk:
        raise ValueError("ssd_ref(round_to=...) needs the chunk its roundings follow")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    if round_to is not None:
        dA = dtf * Af                                          # [b,s,h]
        xdt = (dtf[..., None] * xf).to(round_to).float()       # [b,s,h,p]
    ys = []
    for t in range(s):
        if round_to is not None and t % chunk == 0:
            c0, h_in = t, state                                # the chunk's first step
            cs = torch.cumsum(dA[:, t:t + chunk], dim=1)       # [b,l,h]
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]
        upd = (dtf[:, t, :, None] * Bh[:, t])[..., :, None] * xf[:, t, :, None, :]
        state = state * decay + upd
        if round_to is None:
            ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
            continue
        i = t - c0
        y_off = torch.exp(cs[:, i])[..., None] * torch.einsum("bhn,bhnp->bhp", Ch[:, t], h_in)
        w = (torch.einsum("bhn,bjhn->bjh", Ch[:, t], Bh[:, c0:t + 1])
             * torch.exp(cs[:, i:i + 1] - cs[:, :i + 1])).to(round_to).float()
        ys.append(y_off + torch.einsum("bjh,bjhp->bhp", w, xdt[:, c0:t + 1]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    return y.to(x.dtype), state


def rglru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Step-by-step diagonal linear recurrence h_t = a_t h_{t-1} + b_t.

    a, b: [B, S, W] (precomputed gates, any float dtype). Returns h [B, S, W]
    in f32, from h_{-1} = 0."""
    af, bf = a.float(), b.float()
    h = af.new_zeros((a.shape[0], a.shape[2]))
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else torch.zeros_like(af)


def rglru_chunked_ref(a: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """The recurrence of ``rglru_ref`` in the CUDA kernel's association.

    The sequence is cut into chunks of ``chunk`` steps. Each chunk's
    aggregate is the product of its a and its h at its end from h = 0; the
    carry into a chunk folds the preceding aggregates in order (carry =
    prod * carry + h_end), and the chunk is walked again from that carry.
    Every product and sum is rounded on its own, as the kernel rounds them,
    so on the card the two agree bit for bit. a, b: [B, S, W]; returns h
    [B, S, W] in f32."""
    af, bf = a.float(), b.float()
    carry = af.new_zeros((a.shape[0], a.shape[2]))
    hs = []
    for c0 in range(0, a.shape[1], chunk):
        h, prod, h_end = carry, torch.ones_like(carry), torch.zeros_like(carry)
        for t in range(c0, min(c0 + chunk, a.shape[1])):
            h = af[:, t] * h + bf[:, t]
            hs.append(h)
            prod = prod * af[:, t]
            h_end = af[:, t] * h_end + bf[:, t]
        carry = prod * carry + h_end
    return torch.stack(hs, dim=1) if hs else torch.zeros_like(af)
