"""Event telemetry of the port's engine: a bounded per-scenario event ring
carried through the steps (``trace_mode="window"`` with
``NetConfig.event_ring_slots > 0``), the torch twin of the JAX package's
``netsim/obs/events.py``.

Each step evaluates a static list of candidate events (one per possible
event source), each with a ``[B]`` predicate ``fired`` computed from
quantities the step already produced, and scatters the fired candidates into
a circular buffer. ``count`` is the monotone total of events ever fired, so
an overflow is observable (the oldest events are evicted, never miscounted).

Taxonomy (``EVENT_KINDS``):

  * ``pfc_xoff`` / ``pfc_xon``       destination-OTN PFC pause asserted /
                                     released (per link at L > 1; ``obj``
                                     is the link index)
  * ``otn_xoff_cross``               total destination-OTN backlog crossed
                                     the xoff threshold upward
  * ``retx_onset``                   retransmit backlog became non-empty
                                     (runs with the loss-repair path only)
  * ``fail_enter`` / ``fail_exit``   a failure-schedule outage window
                                     opened / closed on link ``obj``
  * ``scheme_brake``                 the scheme's proxy brake fired
                                     (matchrdma)
  * ``scheme_budget_on`` / ``_off``  the scheme's repair-budget reservation
                                     engaged / released (sdr_rdma: the
                                     congestion EWMA crossed 0.5)

Schemes add their own candidates through ``Scheme.emit_events``. Runs
without a ring (``event_ring_slots == 0``, the default) build none of this.

On the card every step of a run is captured in a CUDA graph, so nothing
here reads a value back to the host: ring positions come from the device
``count`` and the candidates' fired mask. Every candidate that did not fire
is written to the discard slot E, where several writes land in one step (in
no defined order on the card): nothing reads slot E.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# name -> int32 kind code stored in the ring. Third-party schemes may register
# additional kinds (codes >= 100 stay clear of future engine kinds).
EVENT_KINDS = {
    "pfc_xoff": 0,
    "pfc_xon": 1,
    "otn_xoff_cross": 2,
    "retx_onset": 3,
    "fail_enter": 4,
    "fail_exit": 5,
    "scheme_brake": 6,
    "scheme_budget_on": 7,
    "scheme_budget_off": 8,
}


def kind_name(code: int) -> str:
    """Kind code -> taxonomy name (``kind_12`` for unknown codes)."""
    for name, c in EVENT_KINDS.items():
        if c == int(code):
            return name
    return f"kind_{int(code)}"


class EventRing(NamedTuple):
    """Circular event buffer. Leaves are ``[..., E + 1]``: slot ``E`` is the
    discard slot every non-fired candidate is written to, so the per-step
    write is a fixed-shape scatter with no data-dependent control flow.
    Under the batched engine every leaf has a leading ``[B]`` axis."""
    t_us: torch.Tensor    # [..., E+1] f32 event times (simulated us); -1 empty
    kind: torch.Tensor    # [..., E+1] int32 EVENT_KINDS code; -1 empty
    obj: torch.Tensor     # [..., E+1] int32 object index (link id, 0 if N/A)
    value: torch.Tensor   # [..., E+1] f32 payload (backlog bytes, level, ...)
    count: torch.Tensor   # [...] int32: the monotone total of events fired


def init_event_ring(slots: int, batch_shape: tuple = (),
                    device=None) -> EventRing:
    e = int(slots) + 1
    shape = tuple(batch_shape) + (e,)
    return EventRing(
        t_us=torch.full(shape, -1.0, device=device),
        kind=torch.full(shape, -1, dtype=torch.int32, device=device),
        obj=torch.zeros(shape, dtype=torch.int32, device=device),
        value=torch.zeros(shape, device=device),
        count=torch.zeros(tuple(batch_shape), dtype=torch.int32, device=device),
    )


def candidate_codes(candidates, device=None):
    """``(kinds, objs)`` int64 ``[C]`` tensors of a candidate list's static
    ``(kind_name, obj)`` fields; ``ValueError`` for an unknown kind. The
    engine builds them once per run, outside the captured steps."""
    names = [c[0] for c in candidates]
    unknown = [n for n in names if n not in EVENT_KINDS]
    if unknown:
        raise ValueError(
            f"push_events: unknown event kind(s) {unknown!r} - register "
            f"them in repro_torch.netsim.obs.EVENT_KINDS")
    kinds = torch.tensor([EVENT_KINDS[n] for n in names], dtype=torch.int32,
                         device=device)
    objs = torch.tensor([int(c[1]) for c in candidates], dtype=torch.int32,
                        device=device)
    return kinds, objs


def push_events(ring: EventRing, slots: int, t_us, candidates,
                codes=None) -> EventRing:
    """Scatter this step's fired candidates into the ring.

    ``candidates``: sequence of ``(kind_name, obj, value, fired)`` with
    static ``kind_name``/``obj``, ``value`` a float or a tensor of the
    ring's batch shape and ``fired`` a bool tensor of that shape. Fired
    candidates take consecutive ring positions ``(count + rank) mod slots``
    (rank = the exclusive prefix sum of the fired mask, so positions within
    one step never collide while ``slots >= len(candidates)``, which the
    engine checks when it builds the step); non-fired candidates write to
    the discard slot. ``codes``: ``candidate_codes(candidates)``, built
    here when not given."""
    kinds, objs = codes if codes is not None else candidate_codes(
        candidates, ring.count.device)
    bs = ring.count.shape
    dev = ring.count.device
    vals = torch.stack([
        v.to(torch.float32).expand(bs) if torch.is_tensor(v)
        else torch.full(bs, float(v), device=dev) for _, _, v, _ in candidates], -1)
    fired = torch.stack([f.expand(bs) for _, _, _, f in candidates], -1)
    fired_i = fired.to(torch.int32)
    rank = torch.cumsum(fired_i, -1) - fired_i      # exclusive prefix sum
    pos = torch.where(fired, torch.remainder(ring.count[..., None] + rank, slots),
                      slots).to(torch.int64)
    ts = torch.as_tensor(t_us, dtype=torch.float32, device=dev).expand(pos.shape)
    return EventRing(
        t_us=ring.t_us.scatter(-1, pos, ts),
        kind=ring.kind.scatter(-1, pos, kinds.expand(pos.shape)),
        obj=ring.obj.scatter(-1, pos, objs.expand(pos.shape)),
        value=ring.value.scatter(-1, pos, vals),
        count=ring.count + fired_i.sum(-1, dtype=torch.int32),
    )


def engine_event_candidates(ctx, prev_state, state, t):
    """The engine-owned candidate list of one step: a function of the
    (pre, post) state pair and the device step index, evaluated around the
    step, never inside it. ``prev_state`` is the carry before the step: the
    quantities read here (``pause_dst``, ``q_dst``, ``retx_backlog``) are
    new tensors in the post-step state, never rings written in place. The
    candidate count is static: it depends on the link count, the repair
    path and the failure schedule only."""
    multi = ctx.num_links > 1
    cands = []

    # PFC pause edges on the destination-OTN pause state (per link at L > 1)
    pd0, pd1 = prev_state.pause_dst, state.pause_dst
    if multi:
        q_link = state.q_dst.sum(-1)                               # [B, L]
        for li in range(ctx.num_links):
            cands.append(("pfc_xoff", li, q_link[..., li],
                          (pd0[..., li] < 0.5) & (pd1[..., li] >= 0.5)))
            cands.append(("pfc_xon", li, q_link[..., li],
                          (pd0[..., li] >= 0.5) & (pd1[..., li] < 0.5)))
    else:
        q_tot = state.q_dst.sum(-1)
        cands.append(("pfc_xoff", 0, q_tot, (pd0 < 0.5) & (pd1 >= 0.5)))
        cands.append(("pfc_xon", 0, q_tot, (pd0 >= 0.5) & (pd1 < 0.5)))

    # total dst-OTN backlog crossing the (single-pipe) xoff threshold upward
    lead = ctx.xoff_otn.dim()
    prev_tot = prev_state.q_dst.flatten(lead).sum(-1)
    new_tot = state.q_dst.flatten(lead).sum(-1)
    th = ctx.xoff_otn
    cands.append(("otn_xoff_cross", 0, new_tot, (prev_tot < th) & (new_tot >= th)))

    # retransmit-backlog onset (runs with the loss-repair path only, so the
    # candidate count stays static per run)
    if state.retx_backlog is not None:
        pb = prev_state.retx_backlog.sum(-1)
        nb = state.retx_backlog.sum(-1)
        cands.append(("retx_onset", 0, nb, (pb <= 0.0) & (nb > 0.0)))

    # failure-window entry/exit, recomputed from the window table at t and
    # t - 1 (a function of t, no extra carry)
    fw = ctx.params.fail_windows                                  # [B, L, W, 2]
    if fw.shape[-2] > 0:
        t_f = t.to(torch.float32)
        t_us_now = t_f * ctx.dt_us
        t_us_prev = (t_f - 1.0) * ctx.dt_us
        down_now = ((t_us_now >= fw[..., 0]) & (t_us_now < fw[..., 1])).any(-1)
        down_prev = (((t_us_prev >= fw[..., 0]) & (t_us_prev < fw[..., 1])).any(-1)
                     & (t > 0))                                   # [B, L]
        for li in range(fw.shape[-3]):
            cands.append(("fail_enter", li, 0.0,
                          down_now[..., li] & ~down_prev[..., li]))
            cands.append(("fail_exit", li, 1.0,
                          down_prev[..., li] & ~down_now[..., li]))
    return cands


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def decode_events(ring: EventRing, slots: int,
                  cell: Optional[int] = None) -> list:
    """Host-side: ring -> chronologically ordered event dicts
    (``{"t_us", "kind", "obj", "value"}``). For a batched ring (leading
    [B] axis) pass the ``cell`` index. Returns the last ``min(count,
    slots)`` events, oldest first."""
    t, k, o, v, c = (_np(x) for x in ring)
    if t.ndim == 2:
        if cell is None:
            raise ValueError(
                "decode_events: batched ring - pass the cell index")
        t, k, o, v, c = t[cell], k[cell], o[cell], v[cell], c[cell]
    count = int(c)
    n = min(count, slots)
    if count <= slots:
        idx = np.arange(n)
    else:
        start = count % slots
        idx = (start + np.arange(slots)) % slots
    return [{"t_us": float(t[i]), "kind": kind_name(k[i]),
             "obj": int(o[i]), "value": float(v[i])} for i in idx]


def event_count(ring: EventRing) -> np.ndarray:
    """Host-side monotone event totals (scalar, or [B] for a batch)."""
    return _np(ring.count)


def unroll_window(window: dict, steps: int, window_steps: int,
                  cell: Optional[int] = None):
    """Host-side: the [W, ...]-ring trace dict of ``trace_mode="window"``
    -> ``(step_idx, traces)`` in chronological order. ``step_idx`` is the
    [min(steps, W)] array of engine step indices each row corresponds to;
    ``traces`` maps each key to its time-ordered samples. For a batched
    window (leading [B] axis on every leaf) pass ``cell``."""
    w = int(window_steps)
    n = min(int(steps), w)
    if int(steps) <= w:
        idx = np.arange(n)
        step_idx = np.arange(n)
    else:
        start = int(steps) % w
        idx = (start + np.arange(w)) % w
        step_idx = np.arange(int(steps) - w, int(steps))
    out = {}
    for key, arr in window.items():
        a = _np(arr)
        if cell is not None:
            a = a[cell]
        out[key] = a[idx]
    return step_idx, out
