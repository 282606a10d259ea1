"""Cache utilities for serving: allocation, shape specs, sharding, size.

One cache per layer: ``{"k", "v"}`` of [B, Smax, Hk, hd] for attention (of
[B, W, Hk, hd], a ring of the last ``local_window`` positions, for local
attention; with ``decode_k_time_minor`` a global layer's K is time-minor,
[B, Hk, hd, Smax]), ``{"conv_x", "conv_bc", "ssm"}`` (the conv windows and the f32
state) for SSD, ``{"conv", "h"}`` (the conv window and the f32 state) for
RG-LRU. Sharding: batch over ("pod", "data"); kv-heads over "model" when
divisible, else the sequence (``ShardingRules.cache_spec``; a rank's slice of
ceil(Smax / ranks) positions, or of a ring's slots); the states whole over
"model". A split model's prefill and serve step hold exactly those shards.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import ModelConfig, ParallelConfig
from repro_torch.models.transformer import init_caches
from repro_torch.parallel.sharding import ShardingRules, named

__all__ = ["cache_bytes", "cache_shape_specs", "cache_shardings", "init_caches"]


def cache_shape_specs(model: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      rules: Optional[ShardingRules] = None) -> list:
    """The cache as tensors on the ``meta`` device: shapes and dtypes, no
    allocation (JAX's ``eval_shape`` tree). With ``rules`` (a model split
    over "model"), one rank's shards over "model" of ``batch`` rows, the
    caches that rank holds (``init_caches``)."""
    return init_caches(model, batch, max_len, dtype, device="meta", rules=rules)


def cache_shardings(model: ModelConfig, par: ParallelConfig, mesh, batch: int,
                    max_len: int, dtype: torch.dtype = torch.bfloat16):
    """(the cache's placements on ``mesh``, its spec tree)."""
    spec_tree = ShardingRules(model, par).cache_tree_specs(
        cache_shape_specs(model, batch, max_len, dtype))
    return named(mesh, spec_tree), spec_tree


def cache_bytes(model: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of the model's caches (shapes on the meta device; no allocation)."""
    return sum(t.numel() * t.element_size()
               for c in cache_shape_specs(model, batch, max_len, dtype) for t in c.values())
