"""Seconds from the process's start to the window's: imports, the CUDA
context, the weights from the seed, the kernels' build where it is not done
yet, and the warm-up (the checked train steps, or the warm-up requests that
capture the decode graph)."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
