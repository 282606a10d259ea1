"""The median, over the traced window's request batches, of the prefill's
milliseconds as the program times them (``ServeResult.prefill_ms``: host
clock after the device has finished)."""
import statistics

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "model prefill", "request_p95_ms"


def read(run):
    if run.kind != "serve" or not run.prefill_ms:
        return None
    return statistics.median(run.prefill_ms)
