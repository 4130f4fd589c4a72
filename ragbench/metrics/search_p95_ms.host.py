"""95th percentile latency of a search request, from the client's call to
the results in its hand, over every search the window started (the one in
flight at the close is waited for and counts with its real latency), host
clock. The cell's closed loop keeps the DB busy, so this tail follows the
throughput and is read here, beside it, not judged as an end-to-end
metric."""
from ragbench.metrics._lib import SEARCH, VECTORDB
from ragbench.roofline import percentile

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (VECTORDB, "ms", "host_clock",
                                         "search_qps", SEARCH)


def read(ctx):
    w = ctx.window
    lat = [1e3 * (r["end"] - r["start"]) for r in w.requests
           if r["op"] == "search" and r["ok"] and r["start"] < w.t1]
    return percentile(lat, 95.0) if lat else None
