"""Paper Fig. 11: batch-size and embedding-dimension sensitivity (the port
of ``benchmarks/sensitivity.py``)."""
from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus
from repro_torch.metrics.quality import evaluate_traces
from repro_torch.workload.generator import WorkloadConfig
from repro_torch.workload.runner import gold_chunks_for, run_workload


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    rows = []
    n_docs = max(int(40 * scale), 10)
    n_req = max(int(32 * scale), 8)
    corpus = make_corpus(n_docs, seed=5)

    for batch in (1, 2, 4, 8, 16):
        pipe = build_pipeline(corpus, device=device)
        res = run_workload(pipe, corpus, WorkloadConfig(
            query_frac=1.0, n_requests=n_req, update_frac=0.0, seed=6),
            query_batch=batch, evaluate=False)
        rows.append({"bench": f"sensitivity/batch-{batch}", "qps": res.qps})

    for dim in (64, 128, 384, 768):
        pipe = build_pipeline(corpus, device=device, embed_dim=dim)
        rng = np.random.default_rng(0)
        qs, ans, golds = [], [], []
        for d in range(min(16, n_docs)):
            q, a = corpus.question_for(d, rng)
            qs.append(q)
            ans.append(a)
            golds.append(gold_chunks_for(pipe.db, d, a))
        pipe.query(qs, ground_truth=ans, gold_chunks=golds)
        qual = evaluate_traces(pipe.traces, pipe.db)
        st = pipe.db.stats()
        rows.append({"bench": f"sensitivity/dim-{dim}",
                     "context_recall": qual["context_recall_retrieved"],
                     "vector_bytes": st["vector_bytes"]})
    return rows


if __name__ == "__main__":
    emit(run())
