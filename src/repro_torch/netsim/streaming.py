"""Streaming-reduction helpers for ``trace_mode="metrics"``: the fixed-bin
log histogram behind the streamed p99 and Kahan-compensated running sums
(the torch twin of the JAX package's ``netsim/streaming.py``).

Bin 0 holds everything below ``HIST_MIN``; bins 1..HIST_BINS-1 are
log-spaced over [HIST_MIN, HIST_MAX). Inverting the histogram bounds the
quantile's relative error by the bin ratio (~5.6% at 512 bins over 12
decades), whatever the horizon.
"""
from __future__ import annotations

import numpy as np
import torch

HIST_BINS = 512
HIST_MIN = 1.0
HIST_MAX = 1e12
_SPAN = float(np.log(HIST_MAX) - np.log(HIST_MIN))
_LOG_MIN = float(np.log(HIST_MIN))


def hist_bin_index(x: torch.Tensor) -> torch.Tensor:
    """Histogram bin (int64) of a non-negative sample."""
    frac = (torch.log(torch.clamp(x, min=HIST_MIN)) - _LOG_MIN) / _SPAN
    idx = 1 + torch.floor(frac * (HIST_BINS - 1)).to(torch.int64)
    return torch.where(x < HIST_MIN, 0, torch.clamp(idx, 1, HIST_BINS - 1))


def hist_bin_centers() -> np.ndarray:
    """Representative value per bin: 0 for the zero bin, geometric bin
    centers for the log bins (host-side numpy)."""
    edges = np.exp(np.linspace(np.log(HIST_MIN), np.log(HIST_MAX),
                               HIST_BINS))
    return np.concatenate([[0.0], np.sqrt(edges[:-1] * edges[1:])])


def hist_quantile(hist, q: float) -> np.ndarray:
    """Invert a streamed log-histogram (leading axes preserved) into the
    q-quantile estimate, in the unit the histogram was fed (host-side)."""
    hist = np.asarray(hist, np.float64)
    rank = q * hist.sum(axis=-1, keepdims=True)
    idx = (np.cumsum(hist, axis=-1) < rank).sum(axis=-1)
    return hist_bin_centers()[np.clip(idx, 0, HIST_BINS - 1)]


def kahan_add(s: torch.Tensor, c: torch.Tensor, x: torch.Tensor):
    """One Kahan-compensated accumulation step: ``(new_s, new_c)``. Eager
    torch rounds every operation, so the compensation is never reassociated
    away."""
    y = x - c
    t = s + y
    return t, (t - s) - y
