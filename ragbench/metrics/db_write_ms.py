"""A write's time in the vector DB, from the program's own spans: the mean
duration of the ``db.insert`` and ``db.remove`` spans in the traced
sub-window (an insert's rebuild, ``db.rebuild``, inside it). The cells'
one client waits for each write, so its time is the search rate's too."""
from ragbench.metrics._lib import SEARCH, VECTORDB
from ragbench.metrics._program import spans

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (VECTORDB, "ms", "program_span",
                                         "search_qps", SEARCH)


def read(ctx):
    sp = spans(ctx.td)
    writes = [s.t1 - s.t0 for s in sp or ()
              if s.name in ("db.insert", "db.remove")]
    return 1e3 * sum(writes) / len(writes) if writes else None
