"""The vector DB's host work before a search's first launch, from the
program's own spans: per ``db.search`` in the traced sub-window, its
``db.upload_q`` (the queries to the device), ``db.snapshot`` (the mask
copies under the DB's lock, the wait for it included) and both
``db.masks`` (the host mask arithmetic and the two mask uploads), summed
over the calls and divided by their number."""
from ragbench.metrics._lib import SEARCH, VECTORDB
from ragbench.metrics._program import phase_ms_per_call

LAYER, UNIT, SOURCE, MOVES, WORKLOADS = (VECTORDB, "ms", "program_span",
                                         "search_qps", SEARCH)


def read(ctx):
    return phase_ms_per_call(ctx.td, ("db.upload_q", "db.snapshot",
                                      "db.masks"))
