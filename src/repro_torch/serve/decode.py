"""Serving: prefill, then a batched greedy decode loop.

The caches are allocated once by prefill (K/V at ``max_len``, a local
layer's ring at its window, SSD and RG-LRU states at their fixed sizes), and
every decode step updates them in place.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.models.transformer import Cache


def greedy_decode(model: Model, caches: List[Cache], token: torch.Tensor,
                  start_pos: int, steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feeds ``token`` [B] at ``start_pos`` and decodes ``steps`` tokens.

    Returns (tokens [B, steps], logits of the last step [B, V])."""
    out, logits = [], None
    for t in range(steps):
        caches, logits = model.decode_step(caches, token, start_pos + t)
        token = torch.argmax(logits, dim=-1)
        out.append(token)
    if not out:
        return token.new_empty((token.shape[0], 0)), logits
    return torch.stack(out, dim=1), logits


def greedy_generate(model: Model, prompt: torch.Tensor, *, max_new: int = 32,
                    max_len: int = 0) -> torch.Tensor:
    """Prefill ``prompt`` [B, S], then decode greedily; returns [B, max_new]."""
    s = prompt.shape[1]
    caches, logits = model.prefill(prompt, max_len=max_len or (s + max_new))
    token = torch.argmax(logits, dim=-1)
    rest, _ = greedy_decode(model, caches, token, s, max_new - 1)
    return torch.cat([token[:, None], rest], dim=1)
