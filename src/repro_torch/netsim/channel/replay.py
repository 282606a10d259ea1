"""``trace_replay``: deterministic replay of recorded OTN telemetry (the torch
twin of the JAX package's ``netsim/channel/replay.py``).

A ``[L, K, 3]`` schedule (one ``(loss_frac, defer_frac, cap_frac)`` row per
edge per slot) rides in as ``NetParams.chan_schedule``; each step reads its
slot by simulated time, ``floor(t * dt / entry_us) mod K`` with ``entry_us =
channel_schedule_dt_us`` (one entry per step when <= 0). No PRNG: the same
schedule replays the same realization bit for bit.

  ``loss_frac``   in [0, 1]: share of the bytes leaving the pipe that drop.
  ``defer_frac``  in [0, 0.95]: share of the incoming fluid (arrivals plus
                  earlier deferred bytes) held back to later steps.
  ``cap_frac``    in [0, 1]: surviving share of the source-OTN capacity.

A ``(0, 0, 1)`` entry is the bit-exact pass-through (every impairment joins
through a ``where`` whose clean branch is the original tensor), and a config
with no schedule makes the model a pass-through. K is static: a batch whose
cells differ in K raises in ``stack_net_params``. The JSON helpers at the
bottom read and write the JAX package's schedule format.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.netsim.channel.base import (
    ChannelEffects, ChannelInputs, ChannelModel, per_link,
    register_channel_model,
)
from repro_torch.netsim.soft import clip

__all__ = [
    "ReplayState", "TraceReplayChannel", "load_schedule_json",
    "save_schedule_json", "schedule_from_arrays",
]


class ReplayState(NamedTuple):
    """Private state of ``TraceReplayChannel``."""
    sched: torch.Tensor   # [*lead, K, 3] each link's (loss, defer, cap) timeline
    defer: torch.Tensor   # [*lead, F] deferred bytes awaiting release


@register_channel_model("trace_replay")
class TraceReplayChannel(ChannelModel):
    """Replay a recorded per-edge impairment schedule (module docstring)."""

    is_ideal = False
    needs_key = False

    def init_channel_state(self, cfg, params, num_flows: int, key, link=None):
        sched = params.chan_schedule                        # [B, L, K, 3]
        sched = sched[..., 0, :, :] if link is None else sched[..., link, :, :]
        return ReplayState(sched=sched,
                           defer=torch.zeros(*key.shape[:-1], num_flows,
                                             device=key.device))

    def apply_impairments(self, ctx, chan: ReplayState,
                          inp: ChannelInputs) -> ChannelEffects:
        k = int(chan.sched.shape[-2])          # static schedule length
        if k == 0:
            # no schedule: structurally the perfect pipe
            return ChannelEffects(arrivals=inp.pipe_out,
                                  lost=torch.zeros_like(inp.pipe_out),
                                  cap_src=inp.cap_src, chan=chan)
        arrivals, cap_src = inp.pipe_out, inp.cap_src
        # the slot: floor(simulated time / entry duration), looping; a true
        # division, as XLA keeps it for the traced entry duration
        sdt = ctx.params.chan_sched_dt_us
        entry_us = torch.where(sdt > 0.0, sdt, ctx.dt_us)
        t_us = inp.t.to(torch.float32) * ctx.dt_us
        idx = torch.remainder(torch.floor(t_us / entry_us).to(torch.int64), k)
        idx = per_link(idx, cap_src).expand(cap_src.shape)
        row = chan.sched.gather(
            -2, idx[..., None, None].expand(*cap_src.shape, 1, 3))[..., 0, :]
        loss_f = clip(row[..., 0], 0.0, 1.0)[..., None]
        defer_f = clip(row[..., 1], 0.0, 0.95)[..., None]
        cap_f = clip(row[..., 2], 0.0, 1.0)

        lost = torch.where(loss_f > 0.0, arrivals * loss_f, 0.0)
        arrivals = torch.where(loss_f > 0.0, arrivals - lost, arrivals)

        # deferral with release: held bytes re-enter the income; at
        # defer_frac == 0 everything held is released in full
        release = chan.defer
        income = arrivals + release
        held = torch.where(defer_f > 0.0, income * defer_f, 0.0)
        arrivals = torch.where((defer_f > 0.0) | (release > 0.0),
                               income - held, arrivals)

        cap_src = torch.where(cap_f < 1.0, cap_src * cap_f, cap_src)
        return ChannelEffects(arrivals=arrivals, lost=lost, cap_src=cap_src,
                              chan=ReplayState(sched=chan.sched, defer=held))

    def held_bytes(self, chan: ReplayState):
        return chan.defer


# ---------------------------------------------------------------------------
# Schedule I/O: plain JSON of recorded telemetry
# ---------------------------------------------------------------------------

def schedule_from_arrays(loss, defer=None, cap=None) -> tuple:
    """One edge's schedule tuple from per-slot sequences (``None`` = zeros
    for loss/defer, ones for cap), ready for ``NetConfig.channel_schedule``."""
    loss = np.asarray(loss, np.float32)
    k = loss.shape[0]
    defer = (np.zeros(k, np.float32) if defer is None
             else np.asarray(defer, np.float32))
    cap = (np.ones(k, np.float32) if cap is None
           else np.asarray(cap, np.float32))
    if defer.shape[0] != k or cap.shape[0] != k:
        raise ValueError(
            f"schedule_from_arrays: loss/defer/cap lengths differ "
            f"({k}, {defer.shape[0]}, {cap.shape[0]})")
    return tuple((float(l), float(d), float(c))
                 for l, d, c in zip(loss, defer, cap))


def load_schedule_json(path) -> tuple:
    """A recorded schedule file -> ``(channel_schedule, dt_us)``. Malformed
    timelines raise here, naming the edge: every edge needs equal-length
    numeric ``loss``/``defer``/``cap`` sequences, and all edges one length."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError(
            f"load_schedule_json: {path}: expected a JSON object with an "
            f"'edges' list, got {type(doc).__name__}")
    edges = []
    for i, e in enumerate(doc.get("edges", [])):
        if not isinstance(e, dict):
            raise ValueError(
                f"load_schedule_json: {path}: edge {i} must be an object "
                f"with 'loss'/'defer'/'cap' lists, got {type(e).__name__}")
        try:
            edges.append(schedule_from_arrays(
                e.get("loss", ()), e.get("defer"), e.get("cap")))
        except ValueError as err:
            raise ValueError(
                f"load_schedule_json: {path}: edge {i} has a malformed "
                f"timeline: {err}") from err
        except TypeError as err:
            raise ValueError(
                f"load_schedule_json: {path}: edge {i} has non-numeric "
                f"timeline entries: {err}") from err
        if i > 0 and len(edges[i]) != len(edges[0]):
            raise ValueError(
                f"load_schedule_json: {path}: edge {i} has {len(edges[i])} "
                f"schedule entries but edge 0 has {len(edges[0])} - all "
                f"edges of a schedule must share one length (pad short "
                f"edges with (0, 0, 1) pass-through entries)")
    return tuple(edges), float(doc.get("dt_us", 0.0))


def save_schedule_json(path, channel_schedule, dt_us: float = 0.0,
                       note: Optional[str] = None) -> None:
    """Write a ``NetConfig.channel_schedule`` tuple in the format
    ``load_schedule_json`` reads."""
    sched = np.asarray(channel_schedule, np.float32)
    if sched.ndim != 3 or sched.shape[-1] != 3:
        raise ValueError(
            f"save_schedule_json: expected an [L, K, 3] schedule, got "
            f"shape {sched.shape}")
    doc = {"dt_us": float(dt_us),
           "edges": [{"loss": e[:, 0].tolist(),
                      "defer": e[:, 1].tolist(),
                      "cap": e[:, 2].tolist()} for e in sched]}
    if note:
        doc["note"] = note
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
