"""The 95th percentile, over every request completed in the window, of its
time from its batch's send to its last token (a batch's requests finish
together)."""
from bench.yardstick.stats import percentile

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    return percentile(run.requests_ms, 95) if run.kind == "serve" else None
