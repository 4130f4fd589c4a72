"""``ivf_topk``'s share of its roofline, in the traced sub-window: the least
time of its calls' work (the centroids and the live rows of the distinct
probed buckets read once, plus queries and outputs), by the frozen yardstick, over the device
time of its probe, inversion, bucket
scan and list merge kernels."""
from ragbench.metrics._lib import IVF, KERNELS
from ragbench.trace import roofline_share

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (KERNELS, "%", "device_trace",
                                         "search_qps", [IVF])


def read(ctx):
    return None if ctx.td is None else roofline_share(ctx.td, "op.ivf_topk")
