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
from torch_parity import (
    GATE_LEAVES, QUEUE_LEAVES, QUEUE_SCALE, leaves, max_errors,
)

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
    at least ``QUEUE_SCALE`` for a queue level, at least 1 for a pause
    signal)."""
    out = {k: float(np.abs(v).max()) or 1.0 for k, v in leaves(tree).items()}
    for k in out:
        if prefix + k in QUEUE_LEAVES:
            out[k] = max(out[k], QUEUE_SCALE)
        if prefix + k in GATE_LEAVES:
            out[k] = max(out[k], 1.0)
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


# One step's VJP (the soft engine): the gradient of a random linear read of
# the new state and the step's traces with respect to the state before the
# step, every NetParams leaf and every WorkloadParams leaf, from jax.grad and
# from torch.autograd. The read weighs each leaf by 1 / its scale over the
# run (``scales``), so every output counts alike. Each input leaf's gradient
# is held within STEP_REL of the larger of its own magnitude and a floor,
# 1e-5 of the step's largest gradient x scale over the leaf's scale (a
# gradient is a sum of terms up to that size, and f32 rounds each).
def _float_leaves(tree) -> dict:
    return {k: v for k, v in leaves(tree).items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)}


def _named(tree, prefix=""):
    """``{"a.b": leaf}`` of a JAX or torch tree (None skipped, array leaves
    kept as they are)."""
    if tree is None:
        return {}
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        out = {}
        for f in fields:
            out.update(_named(getattr(tree, f), f"{prefix}{f}."))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_named(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def step_vjp_errors(jcfgs, pcfgs, wl, scheme, states, outs, ts, channel=None,
                    seed=0):
    """``{input leaf: (largest error, its step)}`` of one step's VJP at each
    step of ``ts`` (teacher-forced from JAX's ``states``), relative as the
    block comment above states; ``wl`` a JAX-package workload."""
    tmpl = jfl.batch_template(jcfgs)
    dp, _ = jfl.batch_padding(jcfgs)
    jw = jwork.as_workload_batch(wl, len(jcfgs))
    jw = type(jw)(*(jnp.asarray(v) for v in jw))
    jp = jstack(jcfgs)
    sch = jget_scheme(scheme)
    s_scale, o_scale = scales(states), scales(outs, "out.")
    p_scale = {k: (float(np.abs(v).max()) if np.size(v) else 1.0) or 1.0
               for k, v in leaves(jp).items()}
    treedef = jax.tree.structure(at(states, 0))
    rng = np.random.default_rng(seed)
    cot_new = {k: (rng.standard_normal(np.shape(v)[:1] + np.shape(v)[2:])
                   / s_scale[k]).astype(np.float32)
               for k, v in _float_leaves(states).items()}
    cot_out = {k: (rng.standard_normal(np.shape(v)[:1] + np.shape(v)[2:])
                   / o_scale[k]).astype(np.float32)
               for k, v in _float_leaves(outs).items()}

    def jlin(flat, p, w, t):
        st = jax.tree.unflatten(treedef, flat)

        def one(s1, p1, w1):
            step = jfl.make_step_fn(tmpl, w1, sch, 0, params=p1, delay_pad=dp,
                                    channel=channel)
            return step(s1, t)
        new, out = jax.vmap(one)(st, p, w)
        tot = 0.0
        for k, v in _named(new).items():
            if k in cot_new:
                tot = tot + jnp.sum(v * cot_new[k])
        for k, v in _named(out).items():
            if k in cot_out:
                tot = tot + jnp.sum(v * cot_out[k])
        return tot

    # op by op, as the port runs: under jit XLA fuses and rounds otherwise,
    # and a gate that sits on its kink (geopipe's credit, spent to 0 within
    # an ulp) then takes the other side of it
    jgrad = jax.grad(jlin, argnums=(0, 1, 2), allow_int=True)
    ptmpl = pfl.batch_template(pcfgs)
    worst = {}
    for t in ts:
        flat = [jnp.asarray(x) for x in jax.tree.leaves(at(states, t))]
        gflat, gp, gw = jgrad(flat, jp, jw, jnp.int32(t))
        is_f = [np.issubdtype(np.asarray(x).dtype, np.floating) for x in flat]
        names = [k for k in leaves(at(states, t))]
        jgr = {f"state.{n}": np.asarray(g) for n, g, f in zip(names, gflat, is_f) if f}
        jgr.update({f"params.{n}": np.asarray(g) for n, g in zip(jp._fields, gp)})
        jgr.update({f"wl.{n}": np.asarray(g) for n, g in zip(jw._fields, gw)})

        ps = state_from_numpy(at(states, t))
        inputs = {}

        def req(tree, prefix=""):
            if torch.is_tensor(tree):
                if tree.is_floating_point():
                    tree = tree.clone().requires_grad_(True)
                    inputs[f"state.{prefix[:-1]}"] = tree
                return tree
            if isinstance(tree, dict):
                return {k: req(v, f"{prefix}{k}.") for k, v in tree.items()}
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return type(tree)(*(req(getattr(tree, f), f"{prefix}{f}.")
                                    for f in tree._fields))
            return tree
        ps = req(ps)
        pp = stack_net_params(pcfgs)
        pp = type(pp)(*(v.clone().requires_grad_(True) for v in pp))
        pw = pwork.WorkloadParams(*(torch.tensor(np.asarray(v, np.float32),
                                                 requires_grad=True) for v in jw))
        inputs.update({f"params.{n}": v for n, v in zip(pp._fields, pp)})
        inputs.update({f"wl.{n}": v for n, v in zip(pw._fields, pw)})
        step = pfl.make_step_fn(ptmpl, pw, scheme, 0, params=pp, delay_pad=dp,
                                channel=channel)
        new, out = step(ps, torch.tensor(t, dtype=torch.int32))
        tot = 0.0
        for k, v in _named(new).items():
            if k in cot_new:
                tot = tot + (v * torch.as_tensor(cot_new[k])).sum()
        for k, v in _named(out).items():
            if k in cot_out:
                tot = tot + (v * torch.as_tensor(cot_out[k])).sum()
        names = list(inputs)
        grads = torch.autograd.grad(tot, [inputs[n] for n in names],
                                    allow_unused=True)
        pgr = {n: (np.zeros(tuple(inputs[n].shape), np.float32) if g is None
                   else g.numpy()) for n, g in zip(names, grads)}

        def leaf_scale(k):
            kind, name = k.split(".", 1)
            if kind == "state":
                return s_scale.get(name, 1.0)
            return p_scale.get(name, 1.0) if kind == "params" else 1.0
        big = max(float(np.abs(v).max()) * leaf_scale(k) for k, v in jgr.items()
                  if np.size(v))
        for k, a in jgr.items():
            if not np.size(a):
                continue
            assert k in pgr, k
            a = np.asarray(a, np.float64)
            d = float(np.abs(pgr[k] - a).max())
            e = d / max(float(np.abs(a).max()), 1e-5 * big / leaf_scale(k))
            if e > worst.get(k, (-1.0, 0))[0]:
                worst[k] = (e, t)
    return worst
