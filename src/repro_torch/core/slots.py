"""Destination-OTN slot-level observations (Fig. 2(e), left half).

Each slot aggregates egress bytes, the mean intra-DC ACK return time and the
CNP count; ``classify_slot`` compares them (and the local backlog) against
preset thresholds, and ``SlotRing`` keeps the recent history the estimator
aggregates into windows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SlotObs(NamedTuple):
    """One slot's observation (per-scenario scalars)."""
    egress_rate: torch.Tensor    # bytes/s realized in the slot
    ack_delay_us: torch.Tensor   # mean intra-DC ACK return delay
    cnp_count: torch.Tensor      # CNPs in the slot
    local_queue: torch.Tensor    # mean dst-OTN queue occupancy, bytes


class SlotRing(NamedTuple):
    """Ring buffer of the last R slots (last axis R)."""
    rates: torch.Tensor          # [..., R] egress rates
    congested: torch.Tensor      # [..., R] 0/1 congestion flags
    busy: torch.Tensor           # [..., R] backlog present => egress == capability
    idx: torch.Tensor            # [...] int32 - next write position
    count: torch.Tensor          # [...] int32 - total slots ever written


def init_ring(num_slots: int, batch_shape=(), device=None) -> SlotRing:
    z = torch.zeros(*batch_shape, num_slots, device=device)
    zi = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    return SlotRing(rates=z, congested=z.clone(), busy=z.clone(),
                    idx=zi, count=zi.clone())


def classify_slot(obs: SlotObs, cfg, queue_thresh_bytes=None) -> torch.Tensor:
    """Congestion level in [0, 3]: ACK-delay, CNP-frequency and local-backlog
    indicators. ``queue_thresh_bytes`` may be a per-scenario tensor."""
    if queue_thresh_bytes is None:
        queue_thresh_bytes = cfg.queue_thresh_kb * 1024.0
    a = (obs.ack_delay_us > cfg.ack_delay_thresh_us).to(torch.float32)
    c = (obs.cnp_count > cfg.cnp_freq_thresh).to(torch.float32)
    q = (obs.local_queue > queue_thresh_bytes).to(torch.float32)
    return a + c + q


def push_slot(ring: SlotRing, obs: SlotObs, cfg, busy: torch.Tensor = None,
              queue_thresh_bytes=None) -> SlotRing:
    """The ring with ``obs`` written at ``idx`` (a new ring: the write is a
    select against the position, so a caller may still discard it)."""
    level = classify_slot(obs, cfg, queue_thresh_bytes=queue_thresh_bytes)
    if queue_thresh_bytes is None:
        queue_thresh_bytes = cfg.queue_thresh_kb * 1024.0
    if busy is None:
        busy = (obs.local_queue > queue_thresh_bytes).to(torch.float32)
    congested = (level > 0).to(torch.float32)
    r = ring.rates.shape[-1]
    at = torch.arange(r, device=ring.rates.device) == ring.idx[..., None]
    return SlotRing(
        rates=torch.where(at, obs.egress_rate[..., None], ring.rates),
        congested=torch.where(at, congested[..., None], ring.congested),
        busy=torch.where(at, busy[..., None], ring.busy),
        idx=torch.remainder(ring.idx + 1, r),
        count=ring.count + 1,
    )


def ordered_history(ring: SlotRing) -> tuple:
    """(rates, congested, busy, valid), oldest first along the last axis."""
    r = ring.rates.shape[-1]
    pos = torch.arange(r, device=ring.rates.device)
    order = torch.remainder(ring.idx[..., None] + pos, r)     # oldest .. newest
    valid_n = torch.clamp(ring.count, max=r)
    # positions [r - valid_n, r) of the ordered view are valid
    valid = (pos >= (r - valid_n)[..., None]).to(torch.float32)
    return (torch.gather(ring.rates, -1, order),
            torch.gather(ring.congested, -1, order),
            torch.gather(ring.busy, -1, order), valid)
