"""``topk_search``'s share of its roofline, in the traced sub-window: the least
time of its calls' work (the fresh rows it must score read once, plus queries
and outputs), by the frozen yardstick, over the device
time of its tile scan kernel; the
torch top-k that merges its lists is not its own."""
from ragbench.metrics._lib import KERNELS, SEARCH
from ragbench.trace import roofline_share

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (KERNELS, "%", "device_trace",
                                         "search_qps", SEARCH)


def read(ctx):
    return None if ctx.td is None else roofline_share(ctx.td, "op.topk_search")
