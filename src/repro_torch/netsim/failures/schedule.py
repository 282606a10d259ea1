"""``FailureSchedule`` — the host-side builder for hard-outage timelines (a
copy of the JAX package's ``netsim/failures/schedule.py``; plain Python).

Mirrors the ``trace_replay`` schedule idiom: plain Python on the host, a
nested tuple on ``NetConfig`` (static window count W, traced window
times), an f32 ``[L, W, 2]`` NetParams leaf inside the scan. The builder
keeps per-edge window lists ragged while you compose outages
(:meth:`link_outage`, :meth:`site_outage`) and pads them with no-op
``(0, 0)`` windows only when compiling into a config, so every edge
carries the same static W and grids stack (``stack_net_params``).

JSON I/O helpers at the bottom round-trip schedules through the same
plain format ``repro_torch.netsim.channel.replay`` uses for telemetry:

    {"edges": [{"windows": [[down_at_us, up_at_us], ...]}, ...]}

See ``docs/failures.md`` for the engine-side semantics.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

__all__ = ["FailureSchedule", "load_failure_json", "save_failure_json"]

# the no-op padding window: up <= down never fires inside the scan
_NOOP = (0.0, 0.0)


def _check_window(down_at_us: float, up_at_us: float) -> tuple:
    d, u = float(down_at_us), float(up_at_us)
    if d < 0.0:
        raise ValueError(
            f"FailureSchedule: down_at_us must be >= 0, got {d}")
    if u <= d:
        raise ValueError(
            f"FailureSchedule: up_at_us must be > down_at_us for a real "
            f"outage, got ({d}, {u}) — zero-length windows are reserved "
            f"for padding")
    return (d, u)


@dataclass(frozen=True)
class FailureSchedule:
    """Per-edge hard-outage windows over the ``[L]`` link axis.

    ``windows`` is a length-``num_links`` tuple of per-edge window
    tuples, each window a ``(down_at_us, up_at_us)`` pair. Lists may be
    ragged here; :meth:`to_config_tuple` pads them to a common static
    count W with no-op ``(0, 0)`` windows. Builders are functional —
    each returns a new schedule — so outages compose::

        fs = (FailureSchedule.empty(3)
              .link_outage(0, 2_000.0, 5_000.0)
              .site_outage(1, 8_000.0, 9_000.0, cfg.edge_pairs()))
        cfg = fs.apply(cfg)
    """

    num_links: int
    windows: tuple = ()

    def __post_init__(self):
        if self.num_links < 1:
            raise ValueError(
                f"FailureSchedule: num_links must be >= 1, got "
                f"{self.num_links}")
        wins = self.windows or ((),) * self.num_links
        if len(wins) != self.num_links:
            raise ValueError(
                f"FailureSchedule: expected {self.num_links} per-edge "
                f"window lists, got {len(wins)}")
        object.__setattr__(
            self, "windows",
            tuple(tuple((float(d), float(u)) for d, u in edge)
                  for edge in wins))

    @classmethod
    def empty(cls, num_links: int) -> "FailureSchedule":
        """A schedule with no outages on ``num_links`` links."""
        return cls(num_links=num_links)

    # -- composition -------------------------------------------------------
    def link_outage(self, link: int, down_at_us: float,
                    up_at_us: float) -> "FailureSchedule":
        """A new schedule with one hard outage window added on ``link``."""
        if not (0 <= link < self.num_links):
            raise ValueError(
                f"FailureSchedule.link_outage: link {link} outside "
                f"[0, {self.num_links})")
        win = _check_window(down_at_us, up_at_us)
        wins = tuple(edge + (win,) if li == link else edge
                     for li, edge in enumerate(self.windows))
        return dataclasses.replace(self, windows=wins)

    def site_outage(self, site: int, down_at_us: float, up_at_us: float,
                    edge_pairs) -> "FailureSchedule":
        """A new schedule with the window added on EVERY edge incident to
        ``site`` — a whole-datacenter outage. ``edge_pairs`` is the
        resolved per-link (src_site, dst_site) wiring, i.e.
        ``cfg.edge_pairs()``."""
        pairs = tuple(edge_pairs)
        if len(pairs) != self.num_links:
            raise ValueError(
                f"FailureSchedule.site_outage: edge_pairs has "
                f"{len(pairs)} entries, schedule has {self.num_links} "
                f"links")
        incident = [li for li, (s, d) in enumerate(pairs)
                    if site in (int(s), int(d))]
        if not incident:
            raise ValueError(
                f"FailureSchedule.site_outage: no edge is incident to "
                f"site {site} in {pairs}")
        out = self
        for li in incident:
            out = out.link_outage(li, down_at_us, up_at_us)
        return out

    # -- compilation into NetConfig ----------------------------------------
    @property
    def num_windows(self) -> int:
        """The static window count W after padding (max over edges)."""
        return max((len(edge) for edge in self.windows), default=0)

    def to_config_tuple(self) -> tuple:
        """The padded nested tuple for ``NetConfig.failure_schedule``:
        every edge brought to the common count W with no-op ``(0, 0)``
        windows (() when the schedule holds no outages at all)."""
        w = self.num_windows
        if w == 0:
            return ()
        return tuple(edge + (_NOOP,) * (w - len(edge))
                     for edge in self.windows)

    def apply(self, cfg):
        """``cfg`` with this schedule compiled in. Validates that the
        schedule's link count matches ``cfg.num_paths``."""
        if self.num_links != cfg.num_paths:
            raise ValueError(
                f"FailureSchedule.apply: schedule covers {self.num_links} "
                f"links but cfg.num_paths is {cfg.num_paths}")
        return dataclasses.replace(
            cfg, failure_schedule=self.to_config_tuple())


# -- JSON I/O ---------------------------------------------------------------

def save_failure_json(path: str, schedule: FailureSchedule) -> None:
    """Write a schedule as ``{"edges": [{"windows": [[d, u], ...]}]}``."""
    doc = {"edges": [{"windows": [list(w) for w in edge]}
                     for edge in schedule.windows]}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)


def load_failure_json(path: str) -> FailureSchedule:
    """Read a schedule written by :func:`save_failure_json`. Raises a
    ``ValueError`` naming the offending edge on malformed windows."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    edges = doc.get("edges", [])
    if not isinstance(edges, list) or not edges:
        raise ValueError(
            f"{path}: failure json needs a non-empty 'edges' list")
    wins = []
    for li, e in enumerate(edges):
        raw = e.get("windows", []) if isinstance(e, dict) else None
        if raw is None:
            raise ValueError(
                f"{path}: edge {li} is not an object with a 'windows' "
                f"list, got {e!r}")
        edge_wins = []
        for w in raw:
            if not isinstance(w, (list, tuple)) or len(w) != 2:
                raise ValueError(
                    f"{path}: edge {li}: each window is a [down_at_us, "
                    f"up_at_us] pair, got {w!r}")
            edge_wins.append(_check_window(w[0], w[1]))
        wins.append(tuple(edge_wins))
    return FailureSchedule(num_links=len(wins), windows=tuple(wins))
