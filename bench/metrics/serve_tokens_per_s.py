"""Tokens generated in the window (B x N a batch, the prefill's first token
included) over the window's seconds."""
UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    return run.tokens / run.window_s if run.kind == "serve" else None
