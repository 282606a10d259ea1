"""Observability layer of the port's netsim engine, the torch twin of the JAX
package's ``netsim/obs``. Three pillars, all opt-in; with them off the
engine runs exactly as before:

  * **event rings** (``events``): a bounded per-scenario ring of discrete,
    timestamped events carried through the steps under
    ``trace_mode="window"`` + ``NetConfig.event_ring_slots > 0``
  * **timeline export** (``timeline``): window/event/trace data -> Chrome
    trace-event JSON for Perfetto UI / ``chrome://tracing``
  * **launch profiling + manifests** (``profile``): graph-capture vs replay
    time, device memory figures, and JSONL run manifests in the JAX
    package's schema, summarized by ``tools/obs_report.py``
"""
from .events import (EVENT_KINDS, EventRing, candidate_codes, decode_events,
                     engine_event_candidates, event_count, init_event_ring,
                     kind_name, push_events, unroll_window)
from .profile import (MANIFEST_VERSION, git_rev, memory_figures,
                      profiled_traced_batch, read_manifest, write_manifest)
from .timeline import (export_timeline, timeline_cell,
                       timeline_from_traces, timeline_from_window)

__all__ = [
    "EVENT_KINDS", "EventRing", "candidate_codes", "decode_events",
    "engine_event_candidates", "event_count", "init_event_ring", "kind_name",
    "push_events", "unroll_window",
    "MANIFEST_VERSION", "git_rev", "memory_figures",
    "profiled_traced_batch", "read_manifest", "write_manifest",
    "export_timeline", "timeline_cell", "timeline_from_traces",
    "timeline_from_window",
]
