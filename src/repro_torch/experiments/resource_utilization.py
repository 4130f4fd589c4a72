"""Paper Fig. 7: resource-utilization traces per pipeline stage, captured by
the decoupled monitor while indexing + querying run (the port of
``benchmarks/resource_utilization.py``).

The port's monitor samples the card's memory as ``torch_device_bytes``
(bytes held by PyTorch tensors) where the reference's samples
``jax_device_bytes``; its other gauges are the reference's.
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus
from repro_torch.monitor.monitor import MonitorConfig, ResourceMonitor


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    n_docs = max(int(48 * scale), 8)
    corpus = make_corpus(n_docs)
    mon = ResourceMonitor(MonitorConfig(interval_s=0.02)).start()
    try:
        # explicit overrides keep the trace on its historical config (bare
        # PipelineConfig defaults), not the shared BENCH_DEFAULTS
        pipe = build_pipeline(index=False, device=device, capacity=1 << 15,
                              nlist=64, retrieve_k=16, rerank_k=4,
                              flat_capacity=4096)
        mon.add_gauge("db_live", lambda: pipe.db.stats()["live"])
        pipe.index_documents(corpus.all_documents())
        questions = [f"what is the {corpus.facts[d][0].attribute} of "
                     f"{corpus.facts[d][0].subject}?" for d in range(8)]
        pipe.query(questions)
    finally:
        mon.stop()
    rows = []
    for name, buf in mon.buffers.items():
        s = buf.summary()
        if s.get("n"):
            rows.append({"bench": f"resource_utilization/{name}",
                         "mean": s["mean"], "max": s["max"], "n": s["n"]})
    rows.append({"bench": "resource_utilization/probe",
                 "probe_cost_s": mon.probe_cost_s})
    return rows


if __name__ == "__main__":
    emit(run())
