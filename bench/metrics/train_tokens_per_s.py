"""Tokens of every step completed in the window over the window's seconds
(the window ends when its last step's metrics are read on the host)."""
UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    return run.tokens / run.window_s if run.kind == "train" else None
