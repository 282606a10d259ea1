"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Direct formulations (materialised scores, step-by-step recurrences): slow,
obviously correct. The card's checks hold each kernel against them on the
same inputs. The CPU path of flash attention runs ``attention_ref`` and that
of the RG-LRU scan ``rglru_ref``; that of the SSD scan runs the chunked
algorithm in f32 (``ops.ssd_scan_plain``), since the recurrence here is one
step at a time. ``ssd_ref(round_to=, chunk=)`` and ``rglru_chunked_ref``
repeat the kernels' own roundings and association.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  softcap: float = 0.0, window: int = 0,
                  p_dtype: Optional[torch.dtype] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive causal GQA attention. q [B,S,Hq,D]; k,v [B,S,Hk,D].

    Scores, softmax and P.V in f32; the output is cast to q's dtype. With
    ``p_dtype``, P is rounded to that dtype before P.V, as the JAX model
    path rounds it to v's dtype (the kernel keeps it in f32). ``scale``
    multiplies the scores (default D^-0.5).
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
