"""The card's idle share that the vector DB holds: the share of the traced
sub-window in which the device runs nothing while some program ``db.*``
span is open (the DB's host work: snapshot, masks, copy-out, results,
writes). With ``idle_outside_db_share`` it splits ``idle_share.search``
exactly."""
from ragbench.metrics._lib import DEVICE, SEARCH
from ragbench.metrics._program import idle_in_db_s

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (DEVICE, "%", "device_trace",
                                         "search_qps", SEARCH)


def read(ctx):
    s = idle_in_db_s(ctx.td)
    return None if s is None else 100.0 * s / ctx.td.window_s
