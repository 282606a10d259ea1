"""The SSD scan op's share of its roofline in the traced window: the least
time of its forward and backward work at the cell's shapes (the larger of
operations at 989 TFLOP/s and bytes at 3.35 TB/s, ``bench.yardstick.cost``)
for every backward in the window, over the device time of every kernel
launched under the op's forwards (a recompute's included) and backwards."""
from bench.yardstick.cost import least_s, ssd_bwd_cost, ssd_cost

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "train_tokens_per_s"
FORWARD, BACKWARD = "SSDScan", "autograd::engine::evaluate_function: SSDScanBackward"


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    pairs = t.count(BACKWARD)
    device_s = t.device_s_under((FORWARD, BACKWARD))
    if not pairs or not device_s:
        return None
    c = run.cfg
    d_in = c["ssm_expand"] * c["d_model"]
    shape = (run.mix["batch"], run.mix["seq"], d_in // c["ssm_headdim"], c["ssm_headdim"], 1,
             c["ssm_state"], c["ssm_chunk"], 2)
    (f1, b1), (f2, b2) = ssd_cost(*shape), ssd_bwd_cost(*shape)
    return 100.0 * pairs * least_s(f1 + f2, b1 + b2) / device_s
