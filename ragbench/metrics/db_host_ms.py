"""Host time of a search call: the traced sub-window's mean ``search()``
wall time, less the device time of all the sub-window's device operations
(kernels, copies and fills) a search call."""
from ragbench.metrics._lib import SEARCH, VECTORDB

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (VECTORDB, "ms", "device_trace",
                                         "search_qps", SEARCH)


def read(ctx):
    td = ctx.td
    if td is None:
        return None
    calls = td.spans_named("db.search")
    if not calls or not td.device_ops:
        return None
    wall = sum(s[3] - s[2] for s in calls) / 1e6 / len(calls)
    dev = sum(d for _, _, d, _ in td.device_ops) / 1e6 / len(calls)
    return wall - dev
