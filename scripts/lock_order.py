#!/usr/bin/env python3
"""Runtime lock-order check of the port's serving locks.

    python3 scripts/lock_order.py [--device cuda|cpu]

Drives the reference's chaos workload (``tests/test_analysis.py``,
``test_elastic_chaos_lock_order_acyclic``) through the port's elastic
executor: 24 queries, a retrieval replica killed and respawned after the
fifth, a writer stall and one removal after the ninth. It runs once over a
flat ``torch`` DB and once over a 4-shard ``torch_sharded`` DB, both on the
``fused`` rung, so that on the card every search launches its
kernel. Every lock on that path is wrapped by
``repro_torch.analysis.lockorder.instrument`` before the first query:

- ``elastic._lock``: the executor's;
- ``vectordb._mu``: the DB's (``vectordb._mu[i]`` for shard i), and
  ``sharded._mu``, the sharded DB's own;
- ``timer._lock``: the pipeline's stage timer;
- ``accountant._lock``: a ``LatencyAccountant`` that each completion
  reports to, as the serving harness does;
- ``ops._COUNTS._lock``: the kernels' launch counter, taken at every launch;
- ``_build._lock``: the kernel loader's, taken at a library's first use.

Run it in a fresh interpreter: then each kernel library's first load falls
inside the first DB's recorded window. For each DB it prints one line,
``{"lock_order": <db>, "edges": [[a, b], ...], "acquisitions": {lock: n},
"seconds": s}``, and then asserts that the graph is acyclic and that the
executor's and the DB's locks were taken (and, on the card, the launch
counter's). It exits non-zero on any of these.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.lockorder import (  # noqa: E402
    LockOrderGraph, instrument)
from repro_torch.core.registry import build  # noqa: E402
from repro_torch.core.spec import PipelineSpec, StageSpec  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.serving.accounting import (  # noqa: E402
    LatencyAccountant, RequestRecord)
from repro_torch.serving.elastic import ElasticExecutor  # noqa: E402
from repro_torch.workload.corpus import (  # noqa: E402
    CorpusConfig, SyntheticCorpus)
from repro_torch.workload.generator import Request  # noqa: E402
from repro_torch.workload.runner import gold_chunks_for  # noqa: E402

N_DOCS = 24
SEED = 7
N_SHARDS = 4
DBS = ("torch", "torch_sharded")


def spec_for(db: str):
    """The reference test's ``PipelineConfig(index_type="flat", capacity=
    1 << 12, nlist=8, retrieve_k=6, rerank_k=2)`` with vector DB ``db`` on
    the ``fused`` rung."""
    opts = {"index_type": "flat", "capacity": 1 << 12, "nlist": 8,
            "use_kernel": "fused"}
    if db == "torch_sharded":
        opts["n_shards"] = N_SHARDS
    return PipelineSpec(vectordb=StageSpec(db, opts), retrieve_k=6,
                        rerank_k=2)


def run(db: str = "torch", device="cuda"):
    """The chaos workload over vector DB ``db`` on ``device``; returns the
    ``LockOrderGraph`` and the wall seconds of the instrumented part."""
    corpus = SyntheticCorpus(CorpusConfig(n_docs=N_DOCS, seed=SEED))
    pipe = build(spec_for(db), device=device)
    pipe.index_documents(corpus.all_documents())
    rng = np.random.default_rng(SEED)
    qs, ans, golds = [], [], []
    for d in range(N_DOCS):
        q, a = corpus.question_for(d, rng)
        qs.append(q)
        ans.append(a)
        golds.append(gold_chunks_for(pipe.db, d, a))

    ex = ElasticExecutor(pipe, replicas={"retrieval": 2, "generation": 2},
                         default_batch=4, max_replicas=3, max_retries=2)
    acct = LatencyAccountant()
    g = LockOrderGraph()
    instrument(ex, "_lock", "elastic._lock", g)
    shards = getattr(pipe.db, "shards", None)
    if shards is None:
        instrument(pipe.db, "_mu", "vectordb._mu", g)
    else:
        instrument(pipe.db, "_mu", "sharded._mu", g)
        for i, shard in enumerate(shards):
            instrument(shard, "_mu", f"vectordb._mu[{i}]", g)
    instrument(pipe.timer, "_lock", "timer._lock", g)
    instrument(acct, "_lock", "accountant._lock", g)
    # the launch counter and the kernel loader outlive this run: their
    # locks go back after it, so the next run records into its own graph
    shared = [(ops._COUNTS, instrument(ops._COUNTS, "_lock",
                                       "ops._COUNTS._lock", g)),
              (_build, instrument(_build, "_lock", "_build._lock", g))]
    try:
        return g, _chaos(ex, acct, qs, ans, golds, db)
    finally:
        for owner, wrapped in shared:
            owner._lock = wrapped.inner


def _chaos(ex, acct, qs, ans, golds, db) -> float:
    """The reference test's submissions and faults; returns their wall
    seconds, the executor drained."""
    t0 = time.perf_counter()
    ex.start()
    done = threading.Event()
    n_done = []

    def on_done(item):
        acct.observe(RequestRecord(req_id=item.idx, op="query",
                                   arrival_s=item.t_submit - t0,
                                   start_s=item.t_start - t0,
                                   end_s=time.perf_counter() - t0,
                                   ok=not item.failed))
        n_done.append(item.idx)
        if len(n_done) >= len(qs):
            done.set()

    for i, q in enumerate(qs):
        ex.submit(q, ground_truth=ans[i], gold=golds[i], on_done=on_done)
        if i == 4:
            ex.kill_replica("retrieval")       # chaos: kill + respawn path
            ex.spawn_replica("retrieval")
        if i == 8:
            ex.stall_writer(0.05)              # chaos: writer freeze+drain
            ex.submit_mutation(Request(op="removal", step=i, doc_id=3),
                               on_done=lambda err: None)
    ex.drain()
    if not done.wait(30.0):
        raise AssertionError(f"lock order {db}: {len(n_done)} of "
                             f"{len(qs)} queries completed")
    return time.perf_counter() - t0


def acquired(acq, prefix: str) -> int:
    """Acquisitions of the locks named ``prefix`` or ``prefix[i]``."""
    return sum(n for name, n in acq.items()
               if name == prefix or name.startswith(prefix + "["))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    required = ["elastic._lock", "vectordb._mu"]
    if args.device != "cpu":
        required.append("ops._COUNTS._lock")
    for db in DBS:
        g, seconds = run(db, args.device)
        acq = g.acquisitions()
        print(json.dumps({"lock_order": db, "edges": g.edges(),
                          "acquisitions": acq, "seconds": seconds}),
              flush=True)
        g.assert_acyclic()
        missing = [name for name in required if not acquired(acq, name)]
        if missing:
            raise AssertionError(f"lock order {db}: never acquired: "
                                 f"{missing}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
