"""The whole search step's share of the card's peak: the least time of
every kernel call's work in the traced searches (the main index's and the
freshness scan's, by the frozen yardstick) over those searches' wall
time. It bounds what removing a kernel from the path can claim."""
from ragbench.metrics._lib import SEARCH, VECTORDB
from ragbench.roofline import bound
from ragbench.trace import op_cost

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (VECTORDB, "%", "host_clock",
                                         "search_qps", SEARCH)


def read(ctx):
    td = ctx.td
    if td is None:
        return None
    wall = sum((s[3] - s[2]) / 1e9 for s in td.spans_named("db.search"))
    least = 0.0
    for s in td.spans:
        if s[0].startswith("op."):
            c = op_cost(s[0], s[4])
            if c is not None:
                least += bound(c["bytes"], c["flops"], c["peak"])[0]
    return 100.0 * least / wall if wall > 0 and least > 0 else None
