"""Attention: chunked causal GQA (the algorithm's reference), sliding-window
local attention, cached decode (global and ring), and naive causal attention.

Layout conventions (as in the JAX package)
  q        [B, S, Hq, Dh]
  k, v     [B, S, Hk, Dh]       (GQA: Hq = Hk * G)
  cache    k/v  [B, Smax, Hk, Dh] (rope pre-applied to cached K)
  time-minor K  [B, Hk, Dh, Smax] (``decode_k_time_minor``; V stays [B, Smax, Hk, Dh])
  ring     k/v  [B, W, Hk, Dh]    (local attention: position p in slot p % W)

Prefill and training in the port go through ``kernels.ops.flash_attention``
(the Hopper kernel on the card), local attention with its ``window``: the JAX
package computes ``local_attention`` outside Pallas, banded block by block,
and its kernel oracle ``attention_ref`` defines the same window.
``chunked_causal_attention`` and ``banded_local_attention`` are the ports of
the JAX model path's blockwise online softmax and of its banded local
attention; ``model_path_attention`` picks between them, and the flash op's
backward takes the gradient of that recompute, as the JAX package's
``_fa_bwd`` does. Both round p to v's dtype before P.V, where the f32 kernel
keeps f32. Decode attention is plain PyTorch: the JAX package has no kernel
there. Decode over a cache split along its sequence over "model" (the rules'
``cache_spec`` where the kv heads do not divide) attends each rank's slice
and combines the partial softmaxes (``combine_partials``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import attention_ref
from repro_torch.parallel.tensor import Split, max_over_model, reduce_from_model

NEG_INF = -1e30
PosLike = Union[int, torch.Tensor]   # a decode position: an int or a 0-d int tensor


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """[B, S, Hq, D] -> [B, S, Hk, G, D]."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, num_kv, hq // num_kv, d)


def _merge_gqa(o: torch.Tensor) -> torch.Tensor:
    b, s, hk, g, d = o.shape
    return o.reshape(b, s, hk * g, d)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             block_q: int = 1024, block_kv: int = 1024,
                             softcap: float = 0.0) -> torch.Tensor:
    """Exact causal attention, computed block by block with online softmax."""
    b, s, hq, dh = q.shape
    hk = k.shape[2]
    g = hq // hk
    scale = dh ** -0.5

    block_q = min(block_q, s)
    block_kv = min(block_kv, s)
    if s % block_q or s % block_kv:
        blk = math.gcd(s, math.gcd(block_q, block_kv))
        block_q = block_kv = max(blk, 1)
    nq = s // block_q

    qg = _split_gqa(q, hk).float()                           # [b,s,hk,g,dh]
    out_blocks = []
    for i in range(nq):
        q_i = qg[:, i * block_q:(i + 1) * block_q]
        # blocks 0 .. the one holding the block's LAST query row (the JAX
        # code stops at its first row's, which drops keys when block_q > block_kv)
        n_pref = ((i + 1) * block_q - 1) // block_kv + 1
        m = torch.full((b, hk, g, block_q), NEG_INF, device=q.device)
        l = torch.zeros((b, hk, g, block_q), device=q.device)
        acc = torch.zeros((b, hk, g, block_q, dh), device=q.device)
        q_pos = i * block_q + torch.arange(block_q, device=q.device)
        for j in range(n_pref):
            k_j = k[:, j * block_kv:(j + 1) * block_kv]
            v_j = v[:, j * block_kv:(j + 1) * block_kv]
            sblk = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j.float()) * scale
            if softcap > 0:
                sblk = softcap * torch.tanh(sblk / softcap)
            k_pos = j * block_kv + torch.arange(block_kv, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            sblk = sblk.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, sblk.amax(dim=-1))
            p = torch.exp(sblk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v_j.dtype).float(), v_j.float())
            m = m_new
        o_i = acc / torch.clamp(l[..., None], min=1e-37)      # [b,hk,g,bq,dh]
        out_blocks.append(o_i.permute(0, 3, 1, 2, 4))         # [b,bq,hk,g,dh]
    o = torch.cat(out_blocks, dim=1)
    return _merge_gqa(o).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, softcap: float = 0.0) -> torch.Tensor:
    """Exact sliding-window causal attention: position t attends [t-W+1, t],
    at every S (the JAX package falls back to causal attention for S <= W,
    which is the same band)."""
    return flash_attention(q, k, v, softcap=softcap, window=window)


def banded_local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           window: int, softcap: float = 0.0) -> torch.Tensor:
    """Exact sliding-window causal attention, banded as the JAX model path
    computes it: position t attends [t-W+1, t].

    Query blocks of W; each attends its own block and the previous one,
    masked to the exact band; the tail is zero-padded to a whole block.
    Memory O(W^2) per block. For S <= W it is causal attention."""
    b, s, hq, dh = q.shape
    hk = k.shape[2]
    g = hq // hk
    if s <= window:
        return chunked_causal_attention(q, k, v, block_q=min(1024, s),
                                        block_kv=min(1024, s), softcap=softcap)
    w = window
    if s % w:
        # pad the tail (causal: real queries never attend the padded keys)
        pad = (0, 0, 0, 0, 0, w - s % w)
        o = banded_local_attention(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad),
                                   window=window, softcap=softcap)
        return o[:, :s]
    nb = s // w
    qg = _split_gqa(q, hk).reshape(b, nb, w, hk, g, dh)
    kb = k.reshape(b, nb, w, hk, dh)
    vb = v.reshape(b, nb, w, hk, dh)
    # the previous block (block -1 = zeros, masked anyway)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1), kb], dim=2)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1), vb], dim=2)

    sblk = torch.einsum("bnqhgd,bnkhd->bnhgqk", qg.float(), k2.float()) * dh ** -0.5
    if softcap > 0:
        sblk = softcap * torch.tanh(sblk / softcap)
    q_pos = torch.arange(w, device=q.device)[:, None]             # within the block
    k_pos = torch.arange(2 * w, device=q.device)[None, :] - w     # from the block's start
    rel = q_pos - k_pos
    band = (rel >= 0) & (rel < w)
    first_block = torch.arange(nb, device=q.device)[:, None, None] == 0
    valid = band[None] & ~(first_block & (k_pos[None] < 0))      # [nb, w, 2w]
    sblk = sblk.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(sblk, dim=-1)
    o = torch.einsum("bnhgqk,bnkhd->bnqhgd", p.to(v2.dtype).float(), v2.float())
    return o.reshape(b, s, hk * g, dh).to(q.dtype)


FA_BWD_BLOCK = 512   # the block of the JAX package's flash op, whose _fa_bwd recomputes


def model_path_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """The plain attention whose gradient the flash op's backward takes: the
    chunked causal attention with equal blocks, or with a window the banded
    local attention (the JAX model path's train-mode attention either way)."""
    if window:
        return banded_local_attention(q, k, v, window=window, softcap=softcap)
    return chunked_causal_attention(q, k, v, block_q=FA_BWD_BLOCK, block_kv=FA_BWD_BLOCK,
                                    softcap=softcap)


def seq_part(split: Split, rows: int) -> Tuple[int, int]:
    """(the global index of this rank's first row, its rows) of a cache
    split along its sequence (or a ring's slots) over "model", ``rows`` rows
    a rank: ceil(length / ranks), the last rank's padded (``init_attn_cache``,
    GSPMD's layout)."""
    return split.rank * rows, rows


def write_at(t: torch.Tensor, dim: int, index: torch.Tensor, new: torch.Tensor,
             split: Optional[Split] = None) -> None:
    """Writes ``new`` (``t``'s shape, 1 along ``dim``) at the global ``index``
    (a 0-d int tensor) of ``dim``, in place. With ``split``, ``t`` is this
    rank's slice of a sequence split over "model": the rank that owns
    ``index`` writes it, the others keep their rows, by a mask on the device
    (``index`` is never read on the host, so the step can be captured)."""
    if split is None:
        t.index_copy_(dim, index.reshape(1), new)
        return
    off, rows = seq_part(split, t.shape[dim])
    at = index - off
    own = (at >= 0) & (at < rows)
    at = at.clamp(0, rows - 1).reshape(1)
    t.index_copy_(dim, at, torch.where(own, new, t.index_select(dim, at)))


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     split: Split) -> torch.Tensor:
    """softmax(s) @ V from each rank's partial over its slice of the
    sequence: its max ``m`` and sum ``l`` of exp(s - m) [..., 1] and its
    unnormalised ``acc`` [..., Dh], in f32. An all-reduce (MAX) of m over
    "model", each rank rescaling l and acc by exp(m - max), an all-reduce
    (SUM) of both, then acc / l: what GSPMD makes of a softmax over a
    sharded axis (flash decoding's combine). A rank with no valid row has
    m = NEG_INF and l = acc = 0, so it adds nothing."""
    scale = torch.exp(m - max_over_model(m, split))
    la = reduce_from_model(torch.cat([l * scale, acc * scale], dim=-1), split)
    return la[..., 1:] / la[..., :1]


def _attend_one(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                valid: torch.Tensor, softcap: float, split: Optional[Split] = None,
                time_minor: bool = False) -> torch.Tensor:
    """q [B, Hq, Dh] against the cache rows where ``valid`` [Smax] holds
    (K time-minor [B, Hk, Dh, Smax] with ``time_minor``). With ``split`` the
    rows are this rank's slice of the sequence, every rank holds all q
    heads, and the partial softmaxes are combined over "model"
    (``combine_partials``)."""
    b, smax, hk, dh = v_cache.shape
    hq = q.shape[1]
    qg = q.reshape(b, hk, hq // hk, dh)
    eq = "bhgd,bhds->bhgs" if time_minor else "bhgd,bshd->bhgs"
    s = torch.einsum(eq, qg.float(), k_cache.float()) * dh ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~valid, NEG_INF)
    if split is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~valid, 0.0)
        acc = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
        o = combine_partials(m, p.sum(dim=-1, keepdim=True), acc, split)
    return o.reshape(b, hq, dh).to(q.dtype)


def _rows(smax: int, device, split: Optional[Split]) -> torch.Tensor:
    """The global positions of the cache's ``smax`` rows."""
    off = seq_part(split, smax)[0] if split is not None else 0
    return off + torch.arange(smax, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: PosLike, *, softcap: float = 0.0,
                     split: Optional[Split] = None) -> torch.Tensor:
    """One new token against the cache.

    q [B, Hq, Dh] (rope applied at pos); k/v cache [B, Smax, Hk, Dh] with the
    new token already written at ``pos``. Returns [B, Hq, Dh] in q's dtype.
    With ``split`` the cache is this rank's slice of the sequence over
    "model" and q holds every head."""
    valid = _rows(k_cache.shape[1], q.device, split) <= pos
    return _attend_one(q, k_cache, v_cache, valid, softcap, split)


def decode_attention_tm(q: torch.Tensor, k_cache_tm: torch.Tensor, v_cache: torch.Tensor,
                        pos: PosLike, *, softcap: float = 0.0,
                        split: Optional[Split] = None) -> torch.Tensor:
    """One new token against a time-minor K cache: q.K contracts Dh with S
    free, so no step transposes the whole cache.

    q [B, Hq, Dh] (rope applied at pos); K [B, Hk, Dh, Smax] and V
    [B, Smax, Hk, Dh] with the new token already written at ``pos``.
    Returns [B, Hq, Dh] in q's dtype. ``split`` as ``decode_attention``'s."""
    valid = _rows(k_cache_tm.shape[3], q.device, split) <= pos
    return _attend_one(q, k_cache_tm, v_cache, valid, softcap, split, time_minor=True)


def decode_local_attention(q: torch.Tensor, k_ring: torch.Tensor, v_ring: torch.Tensor,
                           pos: PosLike, *, softcap: float = 0.0,
                           split: Optional[Split] = None, window: int = 0) -> torch.Tensor:
    """One new token against a ring of the last W positions.

    q [B, Hq, Dh] (rope applied at pos); k/v ring [B, W, Hk, Dh] with slot
    j holding position pos - ((pos - j) mod W) and the new token already
    written at slot pos % W. Returns [B, Hq, Dh] in q's dtype. With
    ``split`` the ring is this rank's slice of the W = ``window`` slots over
    "model" (each slot's validity read at its global index) and q holds
    every head."""
    w = window or k_ring.shape[1]
    slot = _rows(k_ring.shape[1], q.device, split)
    valid = (slot < w) & (pos - torch.remainder(pos - slot, w) >= 0)
    return _attend_one(q, k_ring, v_ring, valid, softcap, split)


def naive_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Materialised-scores causal attention (a test oracle): the plain version
    with P rounded to v's dtype, as the JAX model path does."""
    return attention_ref(q, k, v, softcap=softcap, window=window, p_dtype=v.dtype)
