"""The benchmark's frozen yardstick: the card's peaks, the roofline bound,
and the operations and bytes that each measured kernel's work needs.

Nothing here imports the program. These are copies, frozen where they stand,
so that a change to the program cannot move the yardstick it is measured
with:

* ``H100`` and ``bound``: ``src/repro_torch/roofline/analysis.py``
  (the NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit);
* the retrieve bound terms: ``src/repro_torch/roofline/retrieve.py``
  (``_io_bytes``, ``_probe_bytes``, ``_corpus_bytes``), without its
  ``port_*`` keys, which count the port kernel's own traffic;
* ``percentile``: ``src/repro_torch/serving/accounting.py`` (numpy's
  linear rule).

Each count is of the work as the algorithm needs it: every input byte read
once and every output byte written once, whatever the kernel reads again.
"""
from ragbench.roofline.counts import (F32, I8, I32, H100, HW, bound,
                                      ivf_topk_cost, percentile,
                                      sq8_topk_cost, topk_search_cost)

__all__ = ["F32", "I8", "I32", "H100", "HW", "bound", "ivf_topk_cost",
           "percentile", "sq8_topk_cost", "topk_search_cost"]
