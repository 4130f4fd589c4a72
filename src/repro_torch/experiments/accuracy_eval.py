"""Paper Fig. 8: quality metrics (context recall, accuracy, factual
consistency) across index schemes and rerankers (the port of
``benchmarks/accuracy_eval.py``)."""
from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus
from repro_torch.metrics.quality import evaluate_traces
from repro_torch.workload.runner import gold_chunks_for


def _eval(pipe, corpus, n_q):
    rng = np.random.default_rng(0)
    qs, ans, golds = [], [], []
    for d in range(n_q):
        q, a = corpus.question_for(d, rng)
        qs.append(q)
        ans.append(a)
        golds.append(gold_chunks_for(pipe.db, d, a))
    pipe.query(qs, ground_truth=ans, gold_chunks=golds)
    return evaluate_traces(pipe.traces, pipe.db)


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    rows = []
    n_docs = max(int(40 * scale), 10)
    n_q = min(max(int(24 * scale), 8), n_docs)
    corpus = make_corpus(n_docs)
    for index_type, quant, nprobe in [("flat", "none", 0),
                                      ("ivf", "none", 8),
                                      ("ivf", "none", 2),
                                      ("ivf", "pq", 8)]:
        pipe = build_pipeline(corpus, device=device, index_type=index_type,
                              quant=quant, nprobe=max(nprobe, 1))
        q = _eval(pipe, corpus, n_q)
        rows.append({
            "bench": f"accuracy/{index_type}-{quant}-np{nprobe}",
            **{k: v for k, v in q.items()}})
    for reranker in ("overlap", "bi", "none"):
        pipe = build_pipeline(corpus, device=device, reranker=reranker)
        q = _eval(pipe, corpus, n_q)
        rows.append({"bench": f"accuracy/rerank-{reranker}",
                     "context_recall": q["context_recall"],
                     "f1": q["f1"]})
    return rows


if __name__ == "__main__":
    emit(run())
