"""What a per-layer metric's reader is given, and the cells it reads in.

A reader is ``ragbench/metrics/<metric>.py``: ``LAYER``, ``UNIT``,
``SOURCE``, ``MOVES`` and ``WORKLOADS`` (as its ``BENCHMARK.json`` entry
has them) and ``read(ctx)``, which returns the metric's value or None when
the run gave it nothing to read (the line then leaves the metric out).
"""
from __future__ import annotations

IVF = "msmarco-minilm.ivf1024.search"
SQ8 = "msmarco-minilm.sq8.search"
SEARCH = [IVF, SQ8]

KERNELS = "kernels: csrc/*.cu"
VECTORDB = "vector DB: core/vectordb.py"
DEVICE = "device: the H100"


class Ctx:
    def __init__(self, cell, window, log, td):
        self.cell, self.window, self.log, self.td = cell, window, log, td
