"""Gradient-based controller autotuning over the differentiable engine (the
torch twin of the JAX package's ``netsim/grad_tune.py``).

Adam straight through the soft-step engine (``NetConfig.soft_step``):
``torch.autograd`` differentiates the streamed sums of a metrics run
(``fluid.run_traced_batch``) with respect to the knob vector, so one Adam
step costs two simulator evaluations per cell (forward + backward) against
the bracket search's five candidates per iteration, and it follows the
objective's slope instead of shrinking a bracket.

``KNOB_BOUNDS``        the tunable controller knobs and their boxes (the
                       boxes ``launch.grad_tune``'s bracket search uses).
``ADVERSARIAL_BOUNDS`` impairment-knob boxes for the adversarial mode:
                       ``tune(..., adversarial=True)`` ascends the channel
                       knobs (under ``impaired``) to find the worst mix for
                       a scheme.
``tune``               clamp-reparameterised Adam over the knob vector,
                       shared across the distance grid; the final knob is
                       scored on the hard engine with the true objective.

The descent objective is a smooth surrogate of the streamed sums (no p99:
the histogram's inversion is piecewise constant):

    surrogate = thr_mean_gbps - 0.5 * mean_buffer_mb - pause_ratio

The reported ``objective`` is the bracket search's score, ``throughput_gbps
- 0.5 * p99_buffer_mb`` of a hard-engine (``soft_step=False``) run at the
tuned knob. ``sim_evals`` counts 2 per Adam step plus 1 for that scoring.

Temperature vs horizon: the backward pass accumulates f32 tangents over the
whole run, and cold temperatures sharpen each step's gate Jacobians, so
``temp=None`` picks ``max(0.3, 1.5e-5 * horizon_us)`` (the JAX package's
measured clean frontier), and gradients are clipped at +-1e6 so that a
blown tangent wastes at most a step (unclipped, ``g * g`` overflows Adam's
second moment and freezes the run).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config.net import (
    NetConfig, batch_template, stack_net_params,
)
from repro_torch.device import resolve_device
from repro_torch.netsim.fluid import (
    WARMUP_FRAC, acc_columns, batch_padding, run_traced_batch,
)
from repro_torch.netsim.soft import clip
from repro_torch.netsim.workload import WorkloadParams, as_workload_batch

__all__ = [
    "KNOB_BOUNDS", "ADVERSARIAL_BOUNDS", "FD_EPS", "TuneResult", "tune",
    "cell_surrogates", "surrogate_from_sums", "true_objective",
    "surrogate_grads", "fd_floor", "fd_grad_errors",
]

# controller knobs the tuner may move, and their boxes; both are per-scenario
# NetParams leaves
KNOB_BOUNDS: Dict[str, Tuple[float, float]] = {
    "budget_headroom": (0.85, 1.0),
    "slot_us": (50.0, 400.0),
}

# impairment knobs of the adversarial mode (channel model ``impaired``)
ADVERSARIAL_BOUNDS: Dict[str, Tuple[float, float]] = {
    "loss_rate": (0.0, 0.05),
    "jitter_us": (0.0, 200.0),
    "flap_depth": (0.0, 1.0),
}


# the finite-difference battery of the JAX package's tests/test_grad.py: each
# knob's central-difference step; NetParams leaves by name, WorkloadParams
# leaves as "wl.<name>" (shifted for every real flow at once). The CPU tests
# hold the FD quotients of these knobs against autograd, and the card checks
# hold the card's gradients of them against the CPU's.
FD_EPS: Dict[str, float] = {
    "one_way_delay_us": 0.5, "otn_capacity_gbps": 0.05, "dst_dc_gbps": 0.05,
    "nic_gbps": 0.05, "pfc_xoff_kb": 1.0, "pfc_xon_kb": 1.0,
    "otn_buffer_bdp_frac": 0.002, "ecn_kmin_kb": 0.5, "ecn_kmax_kb": 0.5,
    "queue_thresh_kb": 0.5, "budget_floor_mbps": 1.0, "budget_headroom": 0.003,
    "geopipe_credit_bdp_frac": 0.0005, "sdr_window_bdp_frac": 0.002,
    "sdr_ack_coalesce_us": 0.5, "sdr_retx_budget_frac": 0.002,
    "loss_rate": 0.002, "loss_burst_len": 0.25, "jitter_us": 1.0,
    "flap_depth": 0.01, "rdmacell_token_bucket_us": 1.0,
    "rdmacell_rob_limit_mb": 0.05, "slot_us": 0.4, "soft_temp": 0.005,
    "wl.window": 4096.0, "wl.total_bytes": 4096.0, "wl.start_us": 0.5,
}


class TuneResult(NamedTuple):
    knobs: Dict[str, float]           # tuned knob values (clamped, final)
    objective: float                  # true objective, hard engine, final knobs
    surrogate: float                  # last soft-surrogate value seen
    sim_evals: int                    # per-cell simulator evaluations spent
    history: List[Dict[str, float]]   # per step {knob..., "surrogate"}


def cell_surrogates(sum_s: dict, n_warm: int) -> torch.Tensor:
    """Each cell's smooth objective ``[B]`` from the streamed per-cell sums
    (``[B]`` each): throughput less the buffer and pause penalties."""
    thr = sum_s["thr_inter"] / n_warm * 8.0 / 1e9          # Gbps
    qdst = sum_s["q_dst"] / n_warm / 1e6                   # mean MB
    pause = sum_s["pause_dst"] / n_warm                    # ratio
    return thr - 0.5 * qdst - pause


def surrogate_from_sums(sum_s: dict, n_warm: int) -> torch.Tensor:
    """Smooth scalar objective: the batch mean of ``cell_surrogates``."""
    return cell_surrogates(sum_s, n_warm).mean()


def surrogate_grads(cfgs: Sequence[NetConfig], workload, scheme,
                    horizon_us: Optional[float] = None, channel=None,
                    device=None, on_forward=None):
    """Each cell's surrogate in a soft-step batch (``cfgs`` with
    ``soft_step``) and its gradient with respect to every leaf of that
    cell's ``NetParams`` and ``WorkloadParams``: ``(surrogates [B], NetParams
    of grads, WorkloadParams of grads)``, the grads ``[B, ...]`` tensors
    (zeros where a leaf does not reach the surrogate). The counterpart of
    ``jax.grad`` of the JAX package's ``_run_traced_batch_impl`` in metrics
    mode. ``on_forward()``, when given, is called between the forward and
    the backward (the card's timing hook)."""
    dev = resolve_device(device)
    tmpl = batch_template(cfgs)
    steps = tmpl.horizon_steps(horizon_us if horizon_us is not None
                               else max(c.horizon_us for c in cfgs))
    warm = int(steps * WARMUP_FRAC)
    delay_pad, hist_slots = batch_padding(cfgs)
    params = stack_net_params(cfgs, device=dev)
    params = type(params)(*(v.clone().requires_grad_(True) for v in params))
    wlp = WorkloadParams(*(torch.as_tensor(v, dtype=torch.float32, device=dev)
                           .requires_grad_(True)
                           for v in as_workload_batch(workload, len(cfgs))))
    _, acc = run_traced_batch(tmpl, params, wlp, scheme, steps, 0, delay_pad,
                              hist_slots, mode="metrics", warm=warm,
                              channel=channel)
    surr = cell_surrogates(acc_columns(acc)["sum_s"], max(steps - warm, 1))
    if on_forward is not None:
        on_forward()
    leaves = list(params) + list(wlp)
    # the cells are independent: each cell's leaves take its own slope
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(surr.sum(), leaves, allow_unused=True), leaves)]
    n = len(params)
    return (surr.detach(), type(params)(*grads[:n]),
            WorkloadParams(*grads[n:]))


def fd_floor(surrogate: float, eps: float) -> float:
    """The roundoff floor of a central difference of step ``eps`` on an f32
    surrogate (tests/test_grad.py's): slopes below it are noise to FD."""
    return 3e-5 * max(abs(surrogate), 1.0) / eps


def fd_grad_errors(grads, ref, surrogate: float, cell: int = 0,
                   ref_cell: Optional[int] = None) -> Dict[str, float]:
    """Each ``FD_EPS`` knob's gradient in cell ``cell`` of ``grads`` against
    cell ``ref_cell`` (default the same) of ``ref``, both ``(NetParams,
    WorkloadParams)`` of grads as ``surrogate_grads`` returns them (a knob's
    elements summed, as its FD shift moves them all): the error relative to
    the larger magnitude, 0 where both stand below ``fd_floor`` of the
    reference ``surrogate``, inf where ``grads``'s is not finite."""
    def total(pair, name, i):
        tree = pair[1] if name.startswith("wl.") else pair[0]
        return float(getattr(tree, name.removeprefix("wl."))[i].double().sum())

    ref_cell = cell if ref_cell is None else ref_cell
    out = {}
    for name, eps in FD_EPS.items():
        a, b = total(grads, name, cell), total(ref, name, ref_cell)
        big = max(abs(a), abs(b))
        if not math.isfinite(a):
            out[name] = math.inf
        elif big <= max(fd_floor(surrogate, eps), 1e-9):
            out[name] = 0.0
        else:
            out[name] = abs(a - b) / big
    return out


def true_objective(rows: Sequence[dict]) -> float:
    """The bracket search's score over a batch of hard-engine metric rows."""
    thr = sum(r["throughput_gbps"] for r in rows) / len(rows)
    buf = sum(r["p99_buffer_mb"] for r in rows) / len(rows)
    return float(thr - 0.5 * buf)


def _adam_step(theta, m, v, g, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    return theta - lr * mhat / (torch.sqrt(vhat) + eps), m, v


def tune(knobs: Sequence[str] = ("budget_headroom",),
         scheme="matchrdma",
         dists: Sequence[float] = (100.0, 1000.0),
         horizon_us: float = 80_000.0,
         workload=None,
         channel: Optional[str] = None,
         steps: int = 8,
         lr_frac: float = 0.08,
         temp: Optional[float] = None,
         adversarial: bool = False,
         base_cfg: Optional[NetConfig] = None,
         init: Optional[Dict[str, float]] = None,
         verbose: bool = False,
         device=None,
         on_step=None) -> TuneResult:
    """Adam-tune ``knobs`` (shared across the ``dists`` grid) by gradient
    descent through the soft-step engine; score the result hard.

    ``lr_frac`` is the Adam step as a fraction of each knob's box width.
    ``temp=None`` picks the horizon-scaled default (module docstring).
    ``adversarial=True`` flips the sign (the tuner minimises the scheme's
    surrogate by moving impairment knobs, from ``ADVERSARIAL_BOUNDS``) and
    defaults the channel to ``"impaired"``. ``device``: where the runs go,
    ``cuda`` unless the caller says. ``on_step(t, seconds)``, when given, is
    called after each Adam step's forward and backward with the step's host
    seconds (the launcher's timing hook)."""
    import time

    from repro_torch.netsim.runner import run_experiment_batch
    from repro_torch.netsim.workload import congestion_workload

    dev = resolve_device(device)
    bounds = ADVERSARIAL_BOUNDS if adversarial else KNOB_BOUNDS
    if adversarial and channel is None:
        channel = "impaired"
    for k in knobs:
        if k not in bounds:
            raise ValueError(f"grad_tune: unknown knob {k!r} "
                             f"(have {sorted(bounds)})")
    lo = torch.tensor([bounds[k][0] for k in knobs], device=dev)
    hi = torch.tensor([bounds[k][1] for k in knobs], device=dev)
    if init is None:
        theta = (lo + hi) / 2.0
    else:
        theta = torch.tensor([init[k] for k in knobs], device=dev)
    wl = congestion_workload() if workload is None else workload
    if temp is None:
        temp = max(0.3, 1.5e-5 * horizon_us)

    if base_cfg is None:
        base_cfg = NetConfig()
    soft_base = dataclasses.replace(base_cfg, soft_step=True, soft_temp=temp,
                                    horizon_us=horizon_us)
    cfgs = [dataclasses.replace(soft_base, distance_km=d) for d in dists]
    b = len(cfgs)
    tmpl = batch_template(cfgs)
    n_steps = tmpl.horizon_steps(None)
    delay_pad, hist_slots = batch_padding(cfgs)
    wlp = WorkloadParams(*(torch.as_tensor(v, dtype=torch.float32, device=dev)
                           for v in as_workload_batch(wl, b)))
    params0 = stack_net_params(cfgs, device=dev)
    warm = int(n_steps * WARMUP_FRAC)
    n_warm = max(n_steps - warm, 1)
    sign = -1.0 if adversarial else 1.0

    def loss(th):
        # clamp reparameterisation: the simulator always sees an in-box
        # knob; the clamp's zero slope outside the box pins a saturated knob
        # at the wall (Adam's momentum walks it back when the slope turns)
        vals = clip(th, lo, hi)
        p = params0._replace(**{k: vals[i].expand(b)
                                for i, k in enumerate(knobs)})
        _, acc = run_traced_batch(tmpl, p, wlp, scheme, n_steps, 0,
                                  delay_pad, hist_slots, mode="metrics",
                                  warm=warm, channel=channel)
        return -sign * surrogate_from_sums(acc_columns(acc)["sum_s"], n_warm)

    lr = lr_frac * (hi - lo)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    history: List[Dict[str, float]] = []
    surr = float("nan")
    for t in range(1, steps + 1):
        t0 = time.perf_counter()
        th = theta.clone().requires_grad_(True)
        val = loss(th)
        (g,) = torch.autograd.grad(val, th)
        if on_step is not None:
            on_step(t, time.perf_counter() - t0)
        # a blown f32 tangent must at worst waste a step
        g = torch.clamp(g, -1e6, 1e6)
        surr = sign * -float(val.detach())
        box = torch.clamp(theta, lo, hi)
        rec = {k: float(box[i]) for i, k in enumerate(knobs)}
        rec["surrogate"] = surr
        history.append(rec)
        if verbose:
            print(f"  adam {t}: surrogate={surr:.3f} "
                  + " ".join(f"{k}={rec[k]:.4g}" for k in knobs), flush=True)
        theta, m, v = _adam_step(theta, m, v, g, t, lr)

    box = torch.clamp(theta, lo, hi)
    final = {k: float(box[i]) for i, k in enumerate(knobs)}
    # hard-engine scoring at the tuned knob: the reported objective is the
    # bracket search's score, never the soft surrogate
    hard = [dataclasses.replace(base_cfg, distance_km=d,
                                horizon_us=horizon_us, **final)
            for d in dists]
    rows = run_experiment_batch(hard, wl, scheme, horizon_us,
                                trace_mode="metrics", channel=channel,
                                device=dev)
    return TuneResult(knobs=final, objective=true_objective(rows),
                      surrogate=surr, sim_evals=2 * steps + 1,
                      history=history)
