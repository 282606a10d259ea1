"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Direct formulations (materialised scores): slow, obviously correct. The CPU
path of every kernel wrapper runs these, and the card's checks hold each
kernel against them on the same inputs.
"""
from __future__ import annotations

from typing import Optional

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
