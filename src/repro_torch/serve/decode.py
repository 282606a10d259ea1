"""Serving: prefill, then a batched greedy decode loop.

The caches are allocated once by prefill (K/V at ``max_len``, a local
layer's ring at its window, SSD and RG-LRU states at their fixed sizes), and
every decode step updates them in place. A model of embedding inputs
(``embed_inputs=False``) is fed the prompt's last embedding at every decode
step, as ``repro.launch.serve`` feeds it, and its argmax tokens
are the output.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.models.transformer import Cache


def greedy_decode(model: Model, caches: List[Cache], token: torch.Tensor,
                  start_pos: int, steps: int, embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feeds ``token`` [B] at ``start_pos`` and decodes ``steps`` tokens;
    with ``embeds`` [B, 1, d] that embedding is fed at every step instead.

    Returns (tokens [B, steps], logits of the last step [B, V])."""
    out, logits = [], None
    for t in range(steps):
        caches, logits = model.decode_step(caches, token if embeds is None else embeds,
                                           start_pos + t)
        token = torch.argmax(logits, dim=-1)
        out.append(token)
    if not out:
        return token.new_empty((token.shape[0], 0)), logits
    return torch.stack(out, dim=1), logits


def greedy_generate(model: Model, prompt: torch.Tensor, *, max_new: int = 32,
                    max_len: int = 0) -> torch.Tensor:
    """Prefill ``prompt`` (tokens [B, S] or embeds [B, S, d]), then decode
    greedily; returns [B, max_new]."""
    s = prompt.shape[1]
    caches, logits = model.prefill(prompt, max_len=max_len or (s + max_new))
    token = torch.argmax(logits, dim=-1)
    last = None if model.cfg.embed_inputs else prompt[:, -1:]
    rest, _ = greedy_decode(model, caches, token, s, max_new - 1, last)
    return torch.cat([token[:, None], rest], dim=1)
