"""The vector DB's host work after a search's lists reach the host, from
the program's own spans: the mean ``db.results`` (one ``SearchResult`` a
query and the counters under the DB's lock) per ``db.search`` in the
traced sub-window."""
from ragbench.metrics._lib import SEARCH, VECTORDB
from ragbench.metrics._program import phase_ms_per_call

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (VECTORDB, "ms", "program_span",
                                         "search_qps", SEARCH)


def read(ctx):
    return phase_ms_per_call(ctx.td, ("db.results",))
