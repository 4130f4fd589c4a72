"""``sq8_topk``'s share of its roofline, in the traced sub-window: the least
time of its calls' work (every live row's int8 codes and the scale read once,
plus queries and outputs), by the frozen yardstick, over the device
time of its limb-product scan and list
merge kernels."""
from ragbench.metrics._lib import KERNELS, SQ8
from ragbench.trace import roofline_share

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (KERNELS, "%", "device_trace",
                                         "search_qps", [SQ8])


def read(ctx):
    return None if ctx.td is None else roofline_share(ctx.td, "op.sq8_topk")
