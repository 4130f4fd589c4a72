"""Paper §5.5 scenario: continuous updates vs index freshness (the port of
``examples/update_freshness.py``).

Runs the same 50/50 query/update workload against three configurations and
prints the latency/accuracy trade-off the paper's Fig. 9 shows:
  1. no temp flat index  -> stable latency, stale answers;
  2. hybrid + uniform    -> fresh answers, latency sawtooth (rebuilds);
  3. hybrid + zipfian    -> fresh answers, gentler growth (fewer uniques).

    PYTHONPATH=src python -m repro_torch.examples.update_freshness [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec, StageSpec
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
from repro_torch.workload.generator import WorkloadConfig
from repro_torch.workload.runner import run_workload


def freshness_spec(use_hybrid: bool) -> PipelineSpec:
    """The reference's ``PipelineConfig(index_type="ivf", nlist=16,
    nprobe=8, capacity=1 << 15, use_hybrid=..., flat_capacity=96,
    rebuild_threshold=0.9)`` as a spec: every other knob at its default."""
    return PipelineSpec(
        vectordb=StageSpec("torch", {
            "index_type": "ivf", "quant": "none", "dim": 384,
            "capacity": 1 << 15, "nlist": 16, "nprobe": 8,
            "use_hybrid": use_hybrid, "flat_capacity": 96,
            "rebuild_threshold": 0.9}),
        llm=StageSpec("extractive", batch_size=8))


def run_config(name, use_hybrid, distribution, device):
    corpus = SyntheticCorpus(CorpusConfig(n_docs=64, seed=1))
    pipe = build(freshness_spec(use_hybrid), device=device)
    pipe.index_documents(corpus.all_documents())
    res = run_workload(pipe, corpus, WorkloadConfig(
        query_frac=0.5, update_frac=0.5, n_requests=120,
        distribution=distribution, seed=2), query_batch=4)
    lat = res.latencies.get("query", [0.0])
    rebuilds = pipe.db.stats()["rebuilds"]
    print(f"{name:18s} qps={res.qps:6.1f} "
          f"query p50={np.median(lat) * 1e3:6.1f}ms "
          f"p95={np.percentile(lat, 95) * 1e3:6.1f}ms "
          f"rebuilds={rebuilds:.0f} "
          f"recall={res.quality['context_recall']:.2f} "
          f"exact={res.quality['exact']:.2f}")
    return {"qps": res.qps, "rebuilds": rebuilds,
            "context_recall": res.quality["context_recall"],
            "exact": res.quality["exact"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("config             throughput  latency                rebuilds  quality")
    return {
        "no-flat uniform": run_config("no-flat uniform", False, "uniform",
                                      device),
        "hybrid uniform": run_config("hybrid uniform", True, "uniform",
                                     device),
        "hybrid zipfian": run_config("hybrid zipfian", True, "zipfian",
                                     device),
    }


if __name__ == "__main__":
    main()
