"""The card's idle share outside the vector DB: the share of the traced
sub-window in which the device runs nothing and no program ``db.*`` span
is open. In the search cells every program span is a ``db.*`` span, so
this is the benchmark's client loop between calls. With
``idle_in_db_share`` it splits ``idle_share.search`` exactly."""
from ragbench.metrics._lib import DEVICE, SEARCH
from ragbench.metrics._program import idle_in_db_s

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (DEVICE, "%", "device_trace",
                                         "search_qps", SEARCH)


def read(ctx):
    s = idle_in_db_s(ctx.td)
    if s is None:
        return None
    td = ctx.td
    return 100.0 * (td.window_s - td.busy_s - s) / td.window_s
