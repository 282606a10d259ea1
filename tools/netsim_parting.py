#!/usr/bin/env python3
"""Where a free run of the port parts from the JAX package's, on one cell of a
held figure (``tests/torch_figure_reference.json``), step by step.

    # the port's run of the cell on the card (no JAX there), saved
    PYTHONPATH=src python tools/netsim_parting.py --figure fig3e --scheme dcqcn \
        --cell 0 --steps 8000 --save chiprun_out/fig3e_dcqcn_0.npz
    # JAX's run of the same cell against a saved run, or against the port's
    # run on the CPU (without --port)
    PYTHONPATH=src python tools/netsim_parting.py --figure fig3e --scheme dcqcn \
        --cell 0 --steps 8000 [--port chiprun_out/fig3e_dcqcn_0.npz]

The scheme's batch is built as the figure builds it: the port's figure
function runs with the other schemes' batches replayed from the reference
file, and the target scheme's call is caught (configs, workloads, horizon,
channel). The port's batch runs ``--steps`` eager steps on ``--device`` (the
card by default; eager steps there are bit-equal to its CUDA graphs),
recording every state leaf of at most ``MAX_LEAF`` elements a cell before
each step; JAX's batch runs as ``jax.lax.scan`` of its step function, vmapped
as ``simulate_batch`` runs it. The comparison prints the first step where a
leaf of the cell parts beyond ``TRACE_REL`` (queues against ``QUEUE_SCALE``
bytes, gates against 1, as ``tests/torch_parity.py`` holds free runs), the
leaves that part there with both runs' values just before and at it, and the
hard thresholds the two runs straddle there: each flow's completion latch
(``delivered >= total_bytes``), the source-OTN PFC (sum of ``q_src`` against
``xoff_otn``) and the destination OTN's PFC (``q_dst`` against ``xoff_otn``
and ``xon_otn = xoff_otn / 2``). The last line is JSON.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]

MAX_LEAF = 64          # leaves of more elements a cell (the rings) are not kept
                       # (--max-leaf keeps them)
# byte counters and queues, read against QUEUE_SCALE bytes (their f32 residues
# are a few 1e-3 B of either sign)
BYTE_LEAVES = ("sent", "acked", "delivered", "inflight", "bytes_ctr", "marked_acc",
               "backlog", "q_src", "q_dst", "q_leaf", "acc_queue", "pipe", "ack_line",
               "retx_line")


class _Caught(Exception):
    pass


def scheme_batch(figure: str, scheme: str):
    """``(cfgs, workload, horizon_us, channel)`` of ``scheme``'s batch of the
    held figure ``figure``, as its figure function builds it."""
    import torch

    import torch_figure_reference as ref
    from repro_torch.launch import netsim as launch

    fig = ref.load()["figures"][figure]
    batches = iter(fig["batches"])

    def run(cfgs, workload, s, horizon_us, *, device=None, profile=None,
            manifest_path=None, **kw):
        b = next(batches)
        if s == scheme:
            raise _Caught(cfgs, workload, horizon_us, kw.get("channel"))
        if profile is not None:
            profile.append({"steps": cfgs[0].horizon_steps(horizon_us),
                            "run_ms": 0.0, "capture_s": 0.0})
        return b["rows"]

    full, horizon = ref.HELD[figure]
    launch_run = launch.run_experiment_batch
    launch.run_experiment_batch = run
    try:
        launch.FIGURES[figure](launch.Figure(figure, torch.device("cpu"), horizon,
                                             profile_steps=0), full=full)
    except _Caught as c:
        return c.args
    finally:
        launch.run_experiment_batch = launch_run
    raise ValueError(f"{figure} runs no batch of {scheme}")


def port_run(figure, scheme, cell, steps, device) -> dict:
    """The port's state leaves of the cell before each of ``steps`` steps."""
    import torch

    from repro_torch.netsim import fluid

    cfgs, wl, _, channel = scheme_batch(figure, scheme)
    _, state, step = fluid.build_batch(cfgs, wl, scheme, device=device,
                                       channel=channel)
    kept = []
    with torch.no_grad():
        for t in range(steps):
            kept.append({k: v[cell].clone() for k, v in _leaf_tensors(state).items()
                         if v.dim() and v[cell].numel() <= MAX_LEAF})
            state, _ = step(state, torch.tensor(t, dtype=torch.int32, device=device))
    out = {k: torch.stack([s[k] for s in kept]).cpu().numpy() for k in kept[0]}
    params = fluid.stack_net_params([cfgs[cell]], device="cpu")
    out["@total_bytes"] = np.asarray(fluid.as_workload_batch(wl, len(cfgs)).total_bytes)[cell]
    out["@xoff_otn"] = np.asarray(max(
        float(params.pfc_xoff_kb[0]) * 1024.0,
        float(params.otn_buffer_bdp_frac[0]) * float(params.otn_capacity_gbps[0]) * 1e9
        / 8.0 * 2.0 * float(params.one_way_delay_us[0]) * 1e-6), np.float32)
    return out


def _leaf_tensors(tree, prefix=""):
    import torch
    if tree is None:
        return {}
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree}
    fields = getattr(tree, "_fields", None)
    items = (zip(fields, tree) if fields is not None else tree.items()
             if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, (tuple, list)) else ())
    out = {}
    for k, v in items:
        out.update(_leaf_tensors(v, f"{prefix}{k}."))
    return out


def jax_run(figure, scheme, cell, steps) -> dict:
    """JAX's state leaves of the cell before each of ``steps`` steps, on the
    same batch."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import repro.netsim  # noqa: F401
    from repro.config.base import NetConfig as JNetConfig
    from repro.config.base import stack_net_params as jstack
    from repro.netsim import fluid as jfl
    from repro.netsim import get_scheme as jget_scheme
    from repro.netsim import workload as jwork
    from torch_parity import leaves

    cfgs, wl, _, channel = scheme_batch(figure, scheme)
    jcfgs = [JNetConfig(**{f: getattr(c, f) for f in c.__dataclass_fields__}) for c in cfgs]
    wls = wl if isinstance(wl, (list, tuple)) else [wl]
    jwl = [jwork.Workload(tuple(jwork.FlowSpec(**dataclasses.asdict(f)) for f in w.flows))
           for w in wls]
    tmpl = jfl.batch_template(jcfgs)
    dp, hs = jfl.batch_padding(jcfgs)
    wlp = jwork.as_workload_batch(jwl if len(jwl) > 1 else jwl[0], len(jcfgs))
    wlp = type(wlp)(*(jnp.asarray(v) for v in wlp))
    sch = jget_scheme(scheme)
    f = wlp.is_inter.shape[-1]

    def one(p, w):
        st0 = jfl.init_state(tmpl, f, params=p, delay_pad=dp, history_slots=hs,
                             scheme=sch, channel=channel)
        step = jfl.make_step_fn(tmpl, w, sch, 0, params=p, delay_pad=dp,
                                channel=channel)

        def body(st, t):
            kept = jax.tree.map(lambda x: x if x.size <= MAX_LEAF else jnp.zeros(()), st)
            return step(st, t)[0], kept

        return jax.lax.scan(body, st0, jnp.arange(steps, dtype=jnp.int32))[1]

    states = jax.jit(jax.vmap(one))(jstack(jcfgs), wlp)
    named = leaves(jax.tree.map(np.asarray, states))
    return {k: v[cell] for k, v in named.items() if v[cell][0].size <= MAX_LEAF
            and v[cell][0].size > 0 and np.ndim(v[cell]) >= 1}


def parting(port: dict, jax: dict, trace_rel: float, queue_scale: float) -> dict:
    """The first step where a leaf of the two runs parts, the leaves that
    part there with both values before and at it, and the thresholds the
    runs straddle at that step."""
    steps = min(len(v) for k, v in port.items() if not k.startswith("@"))
    first, leaves_at = None, {}
    for k in sorted(set(port) & set(jax)):
        a = np.asarray(port[k][:steps], np.float64).reshape(steps, -1)
        b = np.asarray(jax[k][:steps], np.float64).reshape(steps, -1)
        if a.shape != b.shape:
            continue
        leaf = k.split(".")[-1]
        floor = queue_scale if any(leaf.endswith(b) for b in BYTE_LEAVES) else 1.0
        both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
        err = np.where(both_inf, 0.0, np.abs(a - b) / np.maximum(
            np.maximum(np.abs(a), np.abs(b)), floor))
        bad = np.nonzero((err > trace_rel).any(1))[0]
        if len(bad):
            leaves_at[k] = int(bad[0])
    if leaves_at:
        first = min(leaves_at.values())
    out = {"steps": steps, "part": first,
           "leaves": {k: s for k, s in sorted(leaves_at.items(), key=lambda kv: kv[1])}}
    if first is None:
        return out
    at = {}
    for k, s in leaves_at.items():
        if s == first:
            a = np.asarray(port[k], np.float64).reshape(len(port[k]), -1)
            b = np.asarray(jax[k], np.float64).reshape(len(jax[k]), -1)
            cols = np.nonzero(np.abs(a[first] - b[first]) > 0)[0][:8]
            at[k] = {"elements": cols.tolist(),
                     "port": a[max(first - 1, 0):first + 1, cols].tolist(),
                     "jax": b[max(first - 1, 0):first + 1, cols].tolist()}
    out["at"] = at
    out["thresholds"] = straddled(port, jax, first)
    return out


def straddled(port: dict, jax: dict, t: int) -> list:
    """The hard thresholds that the two runs' state lies on either side of at
    step ``t - 1`` or ``t``: each flow's completion latch, the source-OTN and
    the destination-OTN PFC."""
    out = []
    total = np.asarray(port["@total_bytes"], np.float64)
    xoff = float(port["@xoff_otn"])
    for s in (t - 1, t):
        if s < 0:
            continue
        a, b = (np.asarray(r["delivered"][s], np.float64) for r in (port, jax))
        for i in np.nonzero((a >= total) != (b >= total))[0]:
            out.append({"step": s, "threshold": f"flow {i}: delivered >= total_bytes "
                        f"{total[i]:.0f} B (completion latch)", "port": a[i], "jax": b[i]})
        qa, qb = (float(np.sum(r["q_src"][s])) for r in (port, jax))
        if (qa > xoff) != (qb > xoff):
            out.append({"step": s, "threshold": f"sum(q_src) > xoff_otn {xoff:.0f} B "
                        "(source-OTN PFC)", "port": qa, "jax": qb})
        qa, qb = (np.asarray(r["q_dst"][s], np.float64).sum() for r in (port, jax))
        for name, th in (("xoff_otn", xoff), ("xon_otn", xoff / 2.0)):
            if (qa > th) != (qb > th):
                out.append({"step": s, "threshold": f"q_dst against {name} {th:.0f} B "
                            "(destination-OTN PFC)", "port": float(qa), "jax": float(qb)})
    return out


def forced(figure: str, scheme: str, part: int) -> dict:
    """The port's step from JAX's state before each of the steps ``part - 3``
    to ``part`` (tests/torch_netsim_jax.py ``worst_step_errors``): each
    leaf's largest error and the leaves over ``STEP_REL``."""
    import dataclasses

    from repro.config.base import NetConfig as JNetConfig
    from repro.netsim import workload as jwork
    from torch_netsim_jax import jax_states, over_step_limits, port_step, worst_step_errors

    cfgs, wl, _, channel = scheme_batch(figure, scheme)
    jcfgs = [JNetConfig(**{f: getattr(c, f) for f in c.__dataclass_fields__}) for c in cfgs]
    wls = wl if isinstance(wl, (list, tuple)) else [wl]
    jwl = [jwork.Workload(tuple(jwork.FlowSpec(**dataclasses.asdict(f)) for f in w.flows))
           for w in wls]
    states, outs = jax_states(jcfgs, jwl if len(jwl) > 1 else jwl[0], scheme, part + 2,
                              channel)
    worst = worst_step_errors(states, outs, port_step(cfgs, wl, scheme, channel),
                              range(max(part - 3, 0), part + 1))
    return {"largest": max(e for e, _ in worst.values()),
            "over_step_rel": over_step_limits(worst)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--figure", required=True)
    ap.add_argument("--scheme", required=True)
    ap.add_argument("--cell", type=int, required=True,
                    help="the cell's index in the scheme's batch")
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--device", default=None, help="the port's device (default: cuda)")
    ap.add_argument("--save", default="", help="save the port's run here and stop")
    ap.add_argument("--port", default="", help="a saved run of the port's to compare")
    ap.add_argument("--forced", action="store_true",
                    help="also step the port once from JAX's state before each of "
                         "the four steps up to the parting (teacher-forced, on the "
                         "CPU): the step's largest error against tests' STEP_REL")
    ap.add_argument("--max-leaf", type=int, default=None,
                    help=f"keep state leaves of at most this many elements a cell "
                         f"(default {MAX_LEAF})")
    args = ap.parse_args(argv)
    if args.max_leaf:
        globals()["MAX_LEAF"] = args.max_leaf
    if args.port:
        port = dict(np.load(args.port))
    else:
        from repro_torch.device import resolve_device
        port = port_run(args.figure, args.scheme, args.cell, args.steps,
                        resolve_device(args.device))
    if args.save:
        np.savez_compressed(args.save, **port)
        print(json.dumps({"saved": args.save, "leaves": len(port)}))
        return {}
    from torch_parity import QUEUE_SCALE, TRACE_REL

    jax = jax_run(args.figure, args.scheme, args.cell, args.steps)
    out = parting(port, jax, TRACE_REL, QUEUE_SCALE)
    out.update(figure=args.figure, scheme=args.scheme, cell=args.cell)
    if args.forced and out["part"] is not None:
        out["forced"] = forced(args.figure, args.scheme, out["part"])
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
