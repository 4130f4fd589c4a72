"""RAGPerf quickstart: declare a pipeline as a PipelineSpec, build it via
the component registry, index a corpus, benchmark a mixed query/update
workload, print performance + quality metrics (the port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch import resolve_device
from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec, StageSpec
from repro_torch.monitor.monitor import MonitorConfig, ResourceMonitor
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
from repro_torch.workload.generator import WorkloadConfig
from repro_torch.workload.runner import run_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a knowledge corpus (synthetic wiki-style with known facts)
    corpus = SyntheticCorpus(CorpusConfig(n_docs=64, modality="text"))

    # 2. a declarative pipeline spec: each stage names a registered
    #    component + its options (every knob from the paper's §3.3).
    #    The same spec serializes to JSON: see src/repro_torch/specs/.
    spec = PipelineSpec(
        embedder=StageSpec("hash", {"dim": 384}),
        chunker=StageSpec("separator", {"size": 512}),
        vectordb=StageSpec("torch", {"index_type": "ivf", "nlist": 16,
                                     "nprobe": 8, "quant": "none",
                                     "use_hybrid": True,
                                     "flat_capacity": 512}),
        reranker=StageSpec("overlap"),
        llm=StageSpec("extractive"),
        retrieve_k=8, rerank_k=3,
    )
    pipe = build(spec, device=device)
    print("spec:", spec.to_json(indent=None))

    # 3. decoupled low-overhead monitor (paper §3.4)
    monitor = ResourceMonitor(MonitorConfig(interval_s=0.05)).start()
    try:
        monitor.add_gauge("db_live", lambda: pipe.db.stats()["live"])

        n = pipe.index_documents(corpus.all_documents())
        print(f"indexed {n} chunks from {corpus.cfg.n_docs} documents "
              f"on {device}")

        # 4. a workload: 80% queries / 15% updates / 5% inserts, zipfian
        res = run_workload(pipe, corpus, WorkloadConfig(
            query_frac=0.8, update_frac=0.15, insert_frac=0.05,
            distribution="zipfian", n_requests=120, seed=0), query_batch=4)
    finally:
        monitor.stop()
    print(f"\nthroughput: {res.qps:.1f} requests/s")
    print("stage breakdown (s):",
          {k: round(v, 3) for k, v in pipe.breakdown().items()})
    print("per-request stage latency (ms):",
          {k: round(v * 1e3, 2)
           for k, v in pipe.traces[-1].latency_s.items()})
    print("quality:", {k: round(v, 3) for k, v in res.quality.items()})
    print("db stats:", {k: round(v, 1) for k, v in pipe.db_stats().items()
                        if not k.endswith("_s")})
    print("monitor summary:", {k: round(v.get("mean", 0), 2)
                               for k, v in monitor.summary().items()})
    return {"n_chunks": n, "qps": res.qps, "quality": res.quality,
            "queries": len(res.latencies.get("query", []))}


if __name__ == "__main__":
    main()
