"""The port's soft-step helpers (``repro_torch.netsim.soft``) against the JAX
package's (``repro.netsim.soft``): the seven relaxation functions and their
gradients (``jax.grad`` against ``torch.autograd``) on seeded inputs, ties
and saturation included, at 1e-7; and the clamp and absolute value the
engine uses in their place, whose gradients at a tie follow JAX's (half to
each side of ``jnp.maximum``/``jnp.minimum``, slope +1 of ``jnp.abs`` at 0)
where ``torch.clamp`` and ``torch.abs`` differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import soft as jsoft
from repro_torch.netsim import soft as psoft

TOL = 1e-7
RNG = np.random.default_rng(21)
# values on both sides of the thresholds, exactly on them, and deep in the
# +-30 saturation of soft_gt's clip
X = np.concatenate([RNG.normal(0.0, 2.0, 24), [0.0, 1.0, -1.0, 50.0, -50.0, 1e9,
                                               -1e9, 0.5, 0.25]]).astype(np.float32)
THRESH = np.float32(0.5)
TEMP, SCALE = np.float32(0.3), np.float32(2.0)


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1.0)
    assert err <= TOL, f"{what}: {err:.3e}"


def _both(jfn, pfn, *args):
    """Values and the gradient of their sum with respect to every argument,
    from JAX and from torch."""
    jv = jfn(*(jnp.asarray(a) for a in args))
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a)), argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    pv = pfn(*targs)
    pg = torch.autograd.grad(pv.sum(), targs, allow_unused=True)
    pg = [torch.zeros_like(t) if g is None else g for g, t in zip(pg, targs)]
    return jv, pv.detach(), jg, pg


@pytest.mark.parametrize("name", ["soft_gt", "soft_pos", "soft_or", "lerp",
                                  "soft_hysteresis", "ste", "reset_gate"])
def test_soft_function_and_grad_match_jax(name):
    g = RNG.uniform(0.0, 1.0, X.shape).astype(np.float32)
    b = RNG.uniform(0.0, 1.0, X.shape).astype(np.float32)
    cases = {
        "soft_gt": (lambda m: lambda x, t, T: m.soft_gt(x, t, T, SCALE),
                    (X, np.full_like(X, THRESH), np.full_like(X, TEMP))),
        "soft_pos": (lambda m: lambda x, T: m.soft_pos(x, T, SCALE),
                     (X, np.full_like(X, TEMP))),
        "soft_or": (lambda m: m.soft_or, (g, b)),
        "lerp": (lambda m: m.lerp, (g, X, b)),
        "soft_hysteresis": (lambda m: lambda p, q: m.soft_hysteresis(
            p, q, np.float32(4.0), np.float32(2.0), TEMP), (g, X * 3.0)),
        "ste": (lambda m: m.ste, ((X > 0).astype(np.float32), g)),
        "reset_gate": (lambda m: lambda w, x: m.reset_gate(w) * x, (g, X)),
    }
    make, args = cases[name]
    jv, pv, jg, pg = _both(make(jsoft), make(psoft), *args)
    _close(pv, jv, f"{name} value")
    for i, (a, b_) in enumerate(zip(pg, jg)):
        _close(a, b_, f"{name} grad {i}")


def test_soft_gt_saturates_to_an_exact_zero_slope():
    x = torch.tensor([1e9, -1e9, 0.5], requires_grad=True)
    (gx,) = torch.autograd.grad(psoft.soft_gt(x, 0.5, 0.3, 2.0).sum(), x)
    assert gx[0] == 0.0 and gx[1] == 0.0 and gx[2] > 0.0


def test_soft_pos_is_exactly_zero_at_and_below_zero():
    x = torch.tensor([0.0, -3.0, 1e-3])
    out = psoft.soft_pos(x, torch.tensor(0.3), 1.0)
    assert out[0] == 0.0 and out[1] == 0.0 and out[2] > 0.0


def test_temperature_lines_up_from_the_left():
    """A per-scenario [B] temperature against per-flow [B, F] values: row b
    is the gate at temperature b (what JAX's vmap gives)."""
    x = torch.tensor(RNG.normal(0.0, 1.0, (3, 5)), dtype=torch.float32)
    temp = torch.tensor([0.1, 0.5, 2.0])
    out = psoft.soft_gt(x, 0.2, temp, 1.0)
    for b in range(3):
        ref = jsoft.soft_gt(jnp.asarray(x[b].numpy()), 0.2, float(temp[b]), 1.0)
        _close(out[b].numpy(), ref, f"row {b}")


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, None), (None, 1.0)])
def test_clip_ties_match_jax(lo, hi):
    """At a wall the gradient splits as jnp.clip's: 0.5 to x (torch.clamp
    gives 1.0); inside the box 1, outside 0; the bound's share too."""
    x = np.array([0.0, 1.0, 0.5, -2.0, 3.0], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.clip(a, lo, hi)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (pg,) = torch.autograd.grad(psoft.clip(t, lo, hi).sum(), t)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    bound = torch.tensor(0.5, requires_grad=True)
    jb = jax.grad(lambda b: jnp.sum(jnp.maximum(jnp.asarray(x), b)))(0.5)
    (pb,) = torch.autograd.grad(psoft.clip(torch.tensor(x), bound).sum(), bound)
    assert float(pb) == float(jb)


def test_clip_is_torch_clamp_without_autograd():
    x = torch.tensor([0.0, 1.0, 0.5, -2.0, 3.0])
    assert torch.equal(psoft.clip(x, 0.0, 1.0), torch.clamp(x, 0.0, 1.0))
    assert torch.equal(psoft.magnitude(x - 0.5), (x - 0.5).abs())


def test_magnitude_slope_at_zero_matches_jax():
    x = np.array([0.0, -1.5, 2.0], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.abs(a)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (pg,) = torch.autograd.grad(psoft.magnitude(t).sum(), t)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
