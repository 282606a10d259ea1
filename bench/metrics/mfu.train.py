"""The whole train step's share of the card's bf16 peak: 6 x active
parameters x tokens trained in the measured window / its seconds / 989
TFLOP/s. The parameters are counted from the configuration file (an MoE's
k of its E experts; the tied table once)."""
from bench.yardstick.cost import PEAK_FLOPS_BF16
from bench.yardstick.params import active_param_count

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "train step", "train_tokens_per_s"


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return 100.0 * 6.0 * active_param_count(run.cfg) * run.tokens / run.window_s / PEAK_FLOPS_BF16
