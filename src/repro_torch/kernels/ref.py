"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Direct formulations (materialised scores, step-by-step recurrences): slow,
obviously correct. The card's checks hold each kernel against them on the
same inputs. The CPU path of flash attention runs ``attention_ref`` and that
of the RG-LRU scan ``rglru_ref``; that of the SSD scan runs the chunked
algorithm in f32 (``ops.ssd_scan_plain``), since the recurrence here is one
step at a time.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  softcap: float = 0.0, window: int = 0,
                  p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Naive causal GQA attention. q [B,S,Hq,D]; k,v [B,S,Hk,D].

    Scores, softmax and P.V in f32; the output is cast to q's dtype. With
    ``p_dtype``, P is rounded to that dtype before P.V, as the JAX model
    path rounds it to v's dtype (the kernel keeps it in f32).
    """
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = q.reshape(b, s, hk, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * d ** -0.5
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
            C: torch.Tensor, init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step SSD recurrence (O(S) sequential), all in f32.

    x [b,s,h,p]; dt [b,s,h]; A [h] (<0); B,C [b,s,g,n]; init_state [b,h,n,p].
    h_t = h_{t-1} * exp(dt_t A) + dt_t * B_t (x) x_t ;  y_t = C_t . h_t
    Returns (y [b,s,h,p] in x's dtype, final state [b,h,n,p] f32).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]
        upd = (dtf[:, t, :, None] * Bh[:, t])[..., :, None] * xf[:, t, :, None, :]
        state = state * decay + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
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
