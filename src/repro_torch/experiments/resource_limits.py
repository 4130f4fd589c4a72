"""Paper Fig. 10 / §5.6: throughput under constrained resources (the port
of ``benchmarks/resource_limits.py``).

Offline analogues of the paper's three axes:
  host memory  -> vector-store capacity forcing quantized (PQ) indexes,
                  emulating the in-memory -> disk-index transition;
  GPU memory   -> generation batch size cap (the paper: batch limited by
                  KV-cache memory);
  CPU cores    -> retrieval probe width (nprobe): retrieval is the
                  CPU-bound stage in the paper.
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus
from repro_torch.workload.generator import WorkloadConfig
from repro_torch.workload.runner import run_workload


def _qps(pipe, corpus, n_req, batch):
    res = run_workload(pipe, corpus, WorkloadConfig(
        query_frac=1.0, update_frac=0.0, n_requests=n_req, seed=3),
        query_batch=batch, evaluate=False)
    return res.qps


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    rows = []
    n_docs = max(int(40 * scale), 10)
    n_req = max(int(40 * scale), 12)
    corpus = make_corpus(n_docs, seed=4)

    # host-memory axis: full fp32 flat -> IVF -> IVF-PQ (memory shrinks)
    for name, over in [("mem-high-flat", dict(index_type="flat")),
                       ("mem-mid-ivf", dict(index_type="ivf")),
                       ("mem-low-ivfpq", dict(index_type="ivf", quant="pq"))]:
        pipe = build_pipeline(corpus, device=device, **over)
        qps = _qps(pipe, corpus, n_req, 4)
        st = pipe.db.stats()
        rows.append({"bench": f"resource_limits/{name}", "qps": qps,
                     "index_bytes": st["index_bytes"],
                     "vector_bytes": st["vector_bytes"]})

    # generation batch cap (GPU-memory analogue)
    for batch in (1, 4, 8):
        pipe = build_pipeline(corpus, device=device)
        qps = _qps(pipe, corpus, n_req, batch)
        rows.append({"bench": f"resource_limits/gen-batch-{batch}",
                     "qps": qps})

    # probe width (CPU analogue)
    for nprobe in (1, 4, 16):
        pipe = build_pipeline(corpus, device=device, nprobe=nprobe)
        qps = _qps(pipe, corpus, n_req, 4)
        rows.append({"bench": f"resource_limits/nprobe-{nprobe}",
                     "qps": qps})
    return rows


if __name__ == "__main__":
    emit(run())
