"""Cache utilities for serving: allocation and size.

One cache per layer: ``{"k", "v"}`` of [B, Smax, Hk, hd] for attention (of
[B, W, Hk, hd], a ring of the last ``local_window`` positions, for local
attention; with ``decode_k_time_minor`` a global layer's K is time-minor,
[B, Hk, hd, Smax]), ``{"conv_x", "conv_bc", "ssm"}`` (the conv windows and the f32
state) for SSD, ``{"conv", "h"}`` (the conv window and the f32 state) for
RG-LRU.
Sharding specs come with the port's ``parallel`` slice.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.transformer import init_caches

__all__ = ["cache_bytes", "init_caches"]


def cache_bytes(model: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of the model's caches (shapes on the meta device; no allocation)."""
    caches = init_caches(model, batch, max_len, dtype, device="meta")
    return sum(t.numel() * t.element_size() for c in caches for t in c.values())
