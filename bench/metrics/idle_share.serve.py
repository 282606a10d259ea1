"""The device's idle share of a request batch: 1 - the device's busy time
per traced batch (the union of its kernels', copies' and sets' intervals in
the traced window, over the traced batches) / the untraced window's time per
batch. The traced window itself is not the denominator: the profiler's host
overhead stretches it past its untraced length."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "serve_tokens_per_s"


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or not t.kernels or not run.batches:
        return None
    return 100.0 * (1.0 - (t.busy_s / run.mix["traced_batches"]) / (run.window_s / run.batches))
