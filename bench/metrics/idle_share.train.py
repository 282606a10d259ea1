"""The device's idle share of a training step: 1 - the device's busy time
per traced step (the union of its kernels', copies' and sets' intervals in
the traced window, over the traced steps) / the untraced window's time per
step. The traced window itself is not the denominator: the profiler's host
overhead stretches a launch-bound step well past its untraced length."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "train_tokens_per_s"


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.kernels or not run.steps:
        return None
    return 100.0 * (1.0 - (t.busy_s / run.mix["traced_steps"]) / (run.window_s / run.steps))
