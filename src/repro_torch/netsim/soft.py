"""Soft-step relaxation helpers for the differentiable engine (the torch twin
of the JAX package's ``netsim/soft.py``).

With ``NetConfig.soft_step`` the engine and the control stack under it (the
DCQCN machine, the budget controller, the estimators, slot accounting, PFC
hysteresis, the channel impairments) replace every hard select whose
predicate depends on a knob by a sigmoid-tempered blend. The temperature is
the per-scenario ``NetParams.soft_temp`` leaf: as it goes to 0 every gate
converges to the hard step it relaxes. With ``soft_step=False`` none of these
helpers runs.

Conventions:

* every gate is a weight in ``[0, 1]``; callers blend with ``lerp(g, on,
  off)`` instead of ``torch.where``;
* ``scale`` is the natural unit of the compared quantity (us for timers,
  bytes for queues), so the sigmoid's half-width is ``temp * scale`` and
  ``soft_temp`` is dimensionless;
* ``temp`` (and a tensor ``scale``) of lower rank than ``x - thresh`` lines
  up from the left: a per-scenario ``[B]`` temperature against per-flow
  ``[B, F]`` or per-link ``[B, L, F]`` values;
* ``soft_pos`` is exactly 0 at ``x <= 0``, for "any traffic?" gates whose
  quiescent state must stay exactly closed;
* ``ste`` is the straight-through estimator (the hard value forward, the
  smooth surrogate's gradient backward);
* ``reset_gate`` detaches a gate used in its own timer's or counter's reset
  (``t = lerp(w(t), 0, t)``): near the firing equilibrium that recurrence's
  Jacobian exceeds 1 and tangents would grow exponentially through the
  steps, while the same gate keeps its gradient wherever it blends data-path
  quantities.

Gradients at ties follow JAX's: ``jnp.maximum``/``jnp.minimum`` (and
``jnp.clip``, built from them) hand half the gradient to each side of a tie,
where ``torch.clamp`` hands all of it to ``x``; ``jnp.abs`` has slope +1 at
0, where ``torch.abs`` has 0. ``clip`` and ``magnitude`` are the engine's
clamp and absolute value with JAX's gradients.
"""
from __future__ import annotations

import torch

__all__ = ["clip", "magnitude", "ste", "soft_gt", "soft_pos", "soft_or", "lerp",
           "reset_gate", "soft_hysteresis"]

_CONSTS: dict = {}


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``like``'s device and dtype, made once."""
    key = (float(value), like.dtype, like.device)
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.full((), float(value), dtype=like.dtype,
                                      device=like.device)
    return c


def _records_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(x) and x.requires_grad for x in xs)


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (``maximum`` then ``minimum``) with JAX's
    gradient at a wall: half to ``x`` and half to the bound on a tie. Where
    autograd records nothing it is ``torch.clamp`` (the same values, one
    kernel), so the hard step runs what it always ran."""
    if not _records_grad(x, lo, hi):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, lo if torch.is_tensor(lo) else _const(lo, x))
    if hi is not None:
        x = torch.minimum(x, hi if torch.is_tensor(hi) else _const(hi, x))
    return x


def magnitude(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s gradient: slope +1 at 0. Where autograd
    records nothing it is ``torch.abs``."""
    if not _records_grad(x):
        return x.abs()
    return torch.where(x >= 0, x, -x)


def _align(t, z: torch.Tensor):
    """``t`` lined up from the left against ``z`` (module docstring)."""
    if torch.is_tensor(t) and 0 < t.dim() < z.dim():
        return t.reshape(t.shape + (1,) * (z.dim() - t.dim()))
    return t


def ste(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: ``hard`` forward, ``d soft`` backward."""
    return soft + (hard - soft).detach()


def soft_gt(x, thresh, temp, scale):
    """Relaxed ``(x > thresh)``: a sigmoid of half-width ``temp * scale``.
    The argument is clipped at +-30 (the value unchanged to f32 precision),
    so deeply saturated gates have an exactly zero derivative."""
    z = x - thresh
    w = _align(temp, z) * _align(scale, z)
    return torch.sigmoid(clip(z / w, -30.0, 30.0))


def soft_pos(x, temp, scale):
    """Relaxed ``(x > 0)`` that is exactly 0 at ``x <= 0``:
    ``1 - exp(-max(x, 0) / (temp * scale))``."""
    w = _align(temp, x) * _align(scale, x)
    return -torch.expm1(-clip(x, 0.0) / w)


def soft_or(a, b):
    """Probabilistic OR of two gate weights: ``a + b - a * b``."""
    return a + b - a * b


def lerp(gate, on, off):
    """Blend ``gate * on + (1 - gate) * off`` (``where(g, on, off)`` at g in
    {0, 1}), written as the JAX package writes it: ``off + gate * (on -
    off)``."""
    return off + gate * (on - off)


def reset_gate(w: torch.Tensor) -> torch.Tensor:
    """Detach a gate weight for its own state's reset recurrence (module
    docstring): ``|d t' / d t| = 1 - w <= 1`` makes the reset a
    contraction."""
    return w.detach()


def soft_hysteresis(paused, q, xoff, xon, temp):
    """Relaxed PFC xoff/xon hysteresis: above xoff 1, below xon 0, hold in
    between, blended by sigmoids 5% of each threshold wide."""
    up = soft_gt(q, xoff, temp, 0.05 * xoff + 1.0)
    dn = soft_gt(q, xon, temp, 0.05 * xon + 1.0)
    return up + (1.0 - up) * dn * paused
