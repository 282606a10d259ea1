"""The JAX side of the port's netsim parity tests on any scenario batch: a
test-only ``jax.lax.scan`` over ``repro.netsim.fluid.make_step_fn``, vmapped
over the batch as ``simulate_batch`` runs it, that returns the JAX state
before every step and the step's trace dict; and the teacher-forced
comparison of the port's step with it.

Not a test module (pytest collects ``test_*.py`` only). It imports JAX and
the JAX package, so the card tests (which import no JAX) never import it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.netsim  # noqa: F401  (first: repro.core and repro.netsim import each other)
from repro.config.base import stack_net_params as jstack
from repro.netsim import fluid as jfl
from repro.netsim import get_scheme as jget_scheme
from repro.netsim import workload as jwork
from repro_torch.config.net import stack_net_params
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import workload as pwork
from repro_torch.netsim.convert import state_from_numpy
from torch_parity import QUEUE_LEAVES, QUEUE_SCALE, leaves, max_errors

# single steps: each leaf within 1e-6 of its largest value over the run
# (an XLA FMA against torch's two roundings is an ulp, 1.2e-7); integer
# leaves equal; cons_err (a residual of cancelling counters) 1e-6 absolute
STEP_REL = 1e-6
STEP_CONS_ERR_ABS = 1e-6


def jax_states(cfgs, wl, scheme, steps, channel=None):
    """``(states, outs)``: the JAX ``SimState`` before each of ``steps``
    steps (every leaf ``[B, T, ...]``) and the step traces, as numpy, on the
    channel model ``channel`` (None = ideal)."""
    tmpl = jfl.batch_template(cfgs)
    dp, hs = jfl.batch_padding(cfgs)
    wlp = jwork.as_workload_batch(wl, len(cfgs))
    wlp = type(wlp)(*(jnp.asarray(v) for v in wlp))
    sch = jget_scheme(scheme)
    f = wlp.is_inter.shape[-1]

    def one(p, w):
        st0 = jfl.init_state(tmpl, f, params=p, delay_pad=dp,
                             history_slots=hs, scheme=sch, channel=channel)
        step = jfl.make_step_fn(tmpl, w, sch, 0, params=p, delay_pad=dp,
                                channel=channel)

        def body(st, t):
            new, out = step(st, t)
            return new, (st, out)

        return jax.lax.scan(body, st0, jnp.arange(steps, dtype=jnp.int32))[1]

    before, outs = jax.jit(jax.vmap(one))(jstack(cfgs), wlp)
    return jax.tree.map(np.asarray, before), jax.tree.map(np.asarray, outs)


def port_step(cfgs, wl, scheme, channel=None):
    """The port's step function for the same batch, on the CPU."""
    tmpl = pfl.batch_template(cfgs)
    dp, _ = pfl.batch_padding(cfgs)
    wlp = pwork.as_workload_batch(wl, len(cfgs))
    return pfl.make_step_fn(tmpl, wlp, scheme, 0,
                            params=stack_net_params(cfgs, device="cpu"),
                            delay_pad=dp, channel=channel)


def at(tree, t):
    return jax.tree.map(lambda x: x[:, t], tree)


def scales(tree, prefix=""):
    """Largest |value| of every leaf over the whole run (1 where all zero;
    at least ``QUEUE_SCALE`` for a queue level)."""
    out = {k: float(np.abs(v).max()) or 1.0 for k, v in leaves(tree).items()}
    for k in out:
        if prefix + k in QUEUE_LEAVES:
            out[k] = max(out[k], QUEUE_SCALE)
    return out


def worst_step_errors(states, outs, step, ts):
    """Teacher-forced: load JAX's state before each step of ``ts`` into the
    port, step it once, and hold state t+1 and the step's traces to JAX's.
    Returns ``{leaf: (largest error, its step)}`` (``STEP_REL`` scale)."""
    s_scale, o_scale = scales(states), scales(outs, "out.")
    worst = {}
    for t in ts:
        new, out = step(state_from_numpy(at(states, t)),
                        torch.tensor(t, dtype=torch.int32))
        errs = max_errors(new, at(states, t + 1), s_scale)
        errs.update({f"out.{k}": e for k, e in max_errors(
            out, {k: v[:, t] for k, v in outs.items()}, o_scale).items()})
        errs["out.cons_err"] = float(np.abs(out["cons_err"].numpy()
                                            - outs["cons_err"][:, t]).max())
        for k, e in errs.items():
            if e > worst.get(k, (-1.0, 0))[0]:
                worst[k] = (e, t)
    return worst


def over_step_limits(worst):
    return {k: v for k, v in worst.items()
            if v[0] > (STEP_CONS_ERR_ABS if k == "out.cons_err" else STEP_REL)}
