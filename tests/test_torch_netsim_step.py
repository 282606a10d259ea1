"""Teacher-forced single-step parity of the port's fluid step with the JAX
package's, for the paper's four schemes on the golden scenarios of
``tests/golden/generate_goldens.py`` (the congestion cell at 100 km, 10 ms;
the throughput batch at 1 and 300 km, 8 ms).

A test-only ``jax.lax.scan`` over ``repro.netsim.fluid.make_step_fn`` (vmapped
over the batch, as ``simulate_batch`` runs it) returns the JAX ``SimState``
before every step. At sampled steps the state is loaded into the port
(``repro_torch.netsim.convert``), stepped once, and every leaf of state t+1
and of the step's trace dict is held to JAX's: within ``REL`` = 1e-6 of the
leaf's largest value over the run (f32 rounding: XLA contracts multiply-adds
into FMAs, torch rounds each operation, an ulp is 1.2e-7), integer leaves
equal, and ``cons_err`` (a residual of cancelling byte counters, itself of
the order of an ulp) within 1e-6 absolute. The streamed metric
accumulators get the same treatment in ``metrics`` mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.netsim  # noqa: F401  (first: repro.core and repro.netsim import each other)
from repro.config.base import NetConfig as JNetConfig, stack_net_params as jstack
from repro.netsim import fluid as jfl
from repro.netsim import get_scheme as jget_scheme
from repro.netsim import workload as jwork
from repro_torch.config.net import NetConfig, stack_net_params
from repro_torch.netsim import fluid as pfl
from repro_torch.netsim import workload as pwork
from repro_torch.netsim.convert import acc_from_numpy, state_from_numpy
from repro_torch.netsim.fluid import acc_columns
from torch_parity import GOLDEN, PARTS, SCHEMES, leaves, max_errors

REL = 1e-6
CONS_ERR_ABS = 1e-6
# (distances, workload builder and arguments, steps)
SCENARIOS = {name: (d, b, kw, int(h / 5.0)) for name, (d, b, kw, h) in GOLDEN.items()}


def _sampled(steps):
    """Every 9th step, every other slot boundary (steps t with
    (t+1) % 20 == 0, where MatchRDMA's slot update applies) and the steps
    around each recorded parting of the free runs (``PARTS``)."""
    parts = {p + d for p, _ in PARTS.values() for d in (-1, 0)}
    ts = set(range(0, steps, 9)) | set(range(19, steps, 40)) | parts
    return sorted(t for t in ts if t < steps - 1)


def _jax_run(name, scheme, metrics):
    dists, build, kw, steps = SCENARIOS[name]
    cfgs = [JNetConfig(distance_km=d) for d in dists]
    tmpl = jfl.batch_template(cfgs)
    dp, hs = jfl.batch_padding(cfgs)
    wlp = jwork.as_workload_batch(getattr(jwork, build)(**kw), len(cfgs))
    wlp = type(wlp)(*(jnp.asarray(v) for v in wlp))
    sch = jget_scheme(scheme)
    f = wlp.is_inter.shape[-1]
    warm = int(steps * jfl.WARMUP_FRAC)

    def one(p, w):
        st0 = jfl.init_state(tmpl, f, params=p, delay_pad=dp,
                             history_slots=hs, scheme=sch)
        step = jfl.make_step_fn(tmpl, w, sch, 0, params=p, delay_pad=dp)
        acc0 = jfl._init_metric_acc(sch, jfl.get_channel_model(None),
                                    step.ctx, st0)

        def body(carry, t):
            st, acc = carry
            new, out = step(st, t)
            inc = (t >= warm).astype(jnp.float32)
            nacc = jfl._accumulate_engine(acc, out, inc)
            nacc = nacc._replace(scheme=sch.accumulate_metrics(
                step.ctx, nacc.scheme, new, out, inc))
            return (new, nacc), ((st, acc) if metrics else st, out)

        return jax.lax.scan(body, (st0, acc0), jnp.arange(steps, dtype=jnp.int32))

    _, (before, outs) = jax.jit(jax.vmap(one))(jstack(cfgs), wlp)
    return jax.tree.map(np.asarray, before), jax.tree.map(np.asarray, outs)


def _port_step(name, scheme):
    dists, build, kw, _ = SCENARIOS[name]
    cfgs = [NetConfig(distance_km=d) for d in dists]
    tmpl = pfl.batch_template(cfgs)
    dp, _ = pfl.batch_padding(cfgs)
    wl = pwork.as_workload_batch(getattr(pwork, build)(**kw), len(cfgs))
    return pfl.make_step_fn(tmpl, wl, scheme, 0, params=stack_net_params(
        cfgs, device="cpu"), delay_pad=dp)


def _at(tree, t):
    return jax.tree.map(lambda x: x[:, t], tree)


def _scales(tree):
    """Largest |value| of every leaf over the whole run (1 where all zero)."""
    return {k: float(np.abs(v).max()) or 1.0 for k, v in leaves(tree).items()}


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_single_step_matches_jax(name, scheme):
    states, outs = _jax_run(name, scheme, metrics=False)
    step = _port_step(name, scheme)
    s_scale, o_scale = _scales(states), _scales(outs)
    steps = SCENARIOS[name][3]
    worst = {}
    for t in _sampled(steps):
        new, out = step(state_from_numpy(_at(states, t)),
                        torch.tensor(t, dtype=torch.int32))
        errs = max_errors(new, _at(states, t + 1), s_scale)
        errs.update({f"out.{k}": e for k, e in max_errors(
            out, {k: v[:, t] for k, v in outs.items()}, o_scale).items()})
        errs["out.cons_err"] = float(np.abs(out["cons_err"].numpy()
                                            - outs["cons_err"][:, t]).max())
        for k, e in errs.items():
            if e > worst.get(k, (-1.0, 0))[0]:
                worst[k] = (e, t)
    assert len(worst) > 40, sorted(worst)
    bad = {k: v for k, v in worst.items()
           if v[0] > (CONS_ERR_ABS if k == "out.cons_err" else REL)}
    assert not bad, f"leaves over the limit (error, step): {bad}"


@pytest.mark.parametrize("scheme", ["dcqcn", "matchrdma"])
def test_metric_accumulators_step_matches_jax(scheme):
    (states, accs), outs = _jax_run("seq", scheme, metrics=True)
    step = _port_step("seq", scheme)
    acc_scale = _scales(accs)
    warm = int(SCENARIOS["seq"][3] * pfl.WARMUP_FRAC)
    for t in (0, warm - 1, warm, 777, 1998):
        state = state_from_numpy(_at(states, t))
        acc = acc_from_numpy(_at(accs, t))
        new, out = step(state, torch.tensor(t, dtype=torch.int32))
        inc = torch.tensor(float(t >= warm))
        got = pfl._accumulate_engine(acc, out, inc)
        got = got._replace(scheme=pfl.get_scheme(scheme).accumulate_metrics(
            step.ctx, got.scheme, new, out, inc))
        ref = _at(accs, t + 1)
        port = dict(acc_columns(got), hist=got.hist, scheme=got.scheme)
        errs = max_errors(port, {"sum_s": ref.sum_s, "sum_c": ref.sum_c,
                                 "maxes": ref.maxes, "hist": ref.hist,
                                 "scheme": ref.scheme}, acc_scale)
        # the Kahan compensation terms are rounding residue: hold them to an
        # ulp of the sums they compensate
        for k in list(errs):
            if k.startswith("sum_c."):
                errs[k] = float(np.abs(port["sum_c"][k[6:]].numpy()
                                       - ref.sum_c[k[6:]]).max()) / acc_scale["sum_s." + k[6:]]
        assert errs["hist"] == 0.0, t
        assert errs["maxes.cons_err"] <= CONS_ERR_ABS / acc_scale["maxes.cons_err"]
        del errs["maxes.cons_err"]
        assert max(errs.values()) <= REL, (t, errs)
