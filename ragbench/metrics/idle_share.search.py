"""The card's idle share in the traced sub-window: one minus the union of
its operations' intervals over the sub-window's length."""
from ragbench.metrics._lib import SEARCH, DEVICE

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (DEVICE, "%", "device_trace",
                                         "search_qps", SEARCH)


def read(ctx):
    td = ctx.td
    if td is None or td.window_s <= 0 or td.busy_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
