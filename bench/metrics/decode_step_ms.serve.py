"""Device milliseconds a captured decode step takes: the mean, over the
traced window's CUDA graph replays, of the span from a replay's first
kernel's start to its last kernel's end."""
import statistics

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "serve step", "serve_tokens_per_s"


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None:
        return None
    replays = t.graph_replays_s()
    return 1e3 * statistics.mean(replays) if replays else None
