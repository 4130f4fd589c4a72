"""Paper Fig. 12: index-scheme comparison: QPS, build time, memory (the
port of ``benchmarks/index_schemes.py``)."""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus
from repro_torch.workload.generator import WorkloadConfig
from repro_torch.workload.runner import run_workload


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    rows = []
    n_docs = max(int(48 * scale), 12)
    n_req = max(int(32 * scale), 8)
    schemes = [("flat", "none"), ("flat", "sq8"), ("ivf", "none"),
               ("ivf", "sq8"), ("ivf", "pq")]
    for index_type, quant in schemes:
        corpus = make_corpus(n_docs, seed=7)
        pipe = build_pipeline(corpus, device=device, index_type=index_type,
                              quant=quant)
        build_s = pipe.breakdown().get("index_build", 0.0)
        res = run_workload(pipe, corpus, WorkloadConfig(
            query_frac=1.0, update_frac=0.0, n_requests=n_req, seed=8),
            query_batch=4)
        st = pipe.db.stats()
        rows.append({
            "bench": f"index_schemes/{index_type}-{quant}",
            "qps": res.qps,
            "build_s": build_s,
            "index_bytes": st["index_bytes"],
            "context_recall": res.quality["context_recall"],
        })
    return rows


if __name__ == "__main__":
    emit(run())
