"""Lock-step vs per-stage pipelined execution (the stage-graph experiment;
the port of ``benchmarks/stage_pipeline.py``).

Runs the same query stream through (a) lock-step ``RAGPipeline.query`` in
micro-batches (hard barrier after every stage, one global batch size) and
(b) the ``StagedExecutor`` (stages as pipelined workers with bounded
queues), and reports throughput plus per-stage busy/idle/stall time.

Two pipelined configurations are measured:

* ``samebatch`` — identical micro-batch everywhere; isolates pure stage
  overlap (stage N on batch i+1 while stage N+1 runs batch i);
* ``stagebatch`` — the headline: retrieval coalesces 4× larger micro-batches
  than generation.  Lock-step structurally cannot decouple per-stage batch
  sizes; the stage graph can, and retrieval amortizes its per-search store
  transfer over 4× more queries.  This is the stage-level scheduling freedom
  RAGO (arXiv 2503.14649) argues dominates RAG serving performance.

Outputs are asserted identical across all three execution modes, on every
device (an ``AssertionError``, never skipped).
``python -m repro_torch.experiments.stage_pipeline --smoke --device cpu``
emits JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, make_corpus
from repro_torch.serving.staged import StagedExecutor
from repro_torch.workload.runner import gold_chunks_for


def _questions(pipe, corpus, n_q: int):
    rng = np.random.default_rng(0)
    qs, ans, golds = [], [], []
    for i in range(n_q):
        d = i % corpus.cfg.n_docs
        q, a = corpus.question_for(d, rng)
        qs.append(q)
        ans.append(a)
        golds.append(gold_chunks_for(pipe.db, d, a))
    return qs, ans, golds


def _staged_run(pipe, qs, ans, golds, batch: int,
                batch_sizes: Optional[Dict[str, int]],
                expect_answers: List[str]):
    """Warm (lazy device paths + thread paths) then time one pipelined
    pass."""
    executor = StagedExecutor(pipe, batch_sizes=batch_sizes,
                              default_batch=batch)
    warm = executor.run(qs, ground_truth=ans, gold_chunks=golds)
    if [t.answer for t in warm.traces] != expect_answers:
        raise AssertionError("pipelined execution changed outputs")
    pipe.traces.clear()
    executor = StagedExecutor(pipe, batch_sizes=batch_sizes,
                              default_batch=batch)
    res = executor.run(qs, ground_truth=ans, gold_chunks=golds)
    pipe.traces.clear()
    return res


def _run_point(n_docs: int, n_q: int, batch: int, seed: int = 0,
               device="cuda") -> Dict[str, object]:
    corpus = make_corpus(n_docs, seed=seed)
    pipe = build_pipeline(corpus, index_type="flat", capacity=1 << 15,
                          device=device)
    qs, ans, golds = _questions(pipe, corpus, n_q)

    def lockstep():
        for lo in range(0, len(qs), batch):
            pipe.query(qs[lo:lo + batch], ground_truth=ans[lo:lo + batch],
                       gold_chunks=golds[lo:lo + batch])

    # lock-step: barrier after every stage, one micro-batch at a time.
    # The first pass warms every batch shape's first call; the second is
    # timed (each query ends on the host, so the clock sees the device's
    # work).
    lockstep()
    lock_answers = [t.answer for t in pipe.traces]
    pipe.traces.clear()
    t0 = time.perf_counter()
    lockstep()
    lockstep_s = time.perf_counter() - t0
    pipe.traces.clear()

    # pipelined, same global micro-batch: pure stage overlap
    same = _staged_run(pipe, qs, ans, golds, batch, None, lock_answers)
    # pipelined, per-stage batch sizes: retrieval coalesces 4x larger
    # micro-batches than the rest of the graph
    staged = _staged_run(pipe, qs, ans, golds, batch,
                         {"retrieval": 4 * batch}, lock_answers)

    lockstep_qps = n_q / lockstep_s
    return {
        "batch": batch,
        "n_queries": n_q,
        "lockstep_qps": lockstep_qps,
        "samebatch_qps": same.throughput_qps,
        "pipelined_qps": staged.throughput_qps,
        "speedup": staged.throughput_qps / lockstep_qps,
        "stages": staged.report(),
    }


def sweep(scale: float = 1.0, device="cuda") -> List[Dict[str, object]]:
    device = resolve_device(device)
    # per-batch stage work must be well above thread/GIL scheduling noise
    # for the pipelining comparison to measure overlap, not overhead
    n_docs = max(32, int(64 * scale))
    n_q = max(96, int(192 * scale))
    return [_run_point(n_docs, n_q, batch, device=device)
            for batch in (4, 8, 16)]


def run(scale: float = 1.0, device="cuda") -> List[Dict]:
    """``experiments.run`` entry point: lock-step vs pipelined rows."""
    rows = []
    for p in sweep(scale, device):
        tag = f"stage_pipeline/b{p['batch']}"
        rows.append({"bench": tag,
                     "lockstep_qps": p["lockstep_qps"],
                     "samebatch_qps": p["samebatch_qps"],
                     "pipelined_qps": p["pipelined_qps"],
                     "speedup": p["speedup"]})
        for s in p["stages"]:
            rows.append({"bench": f"{tag}/{s['stage']}",
                         "busy_s": s["busy_s"], "idle_s": s["idle_s"],
                         "stall_s": s["stall_s"],
                         "occupancy": s["occupancy"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus/request counts; JSON to stdout")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="", help="optional JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scale = 0.5 if args.smoke else args.scale
    points = sweep(scale, args.device)
    doc = {"sweep": points}
    text = json.dumps(doc, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
