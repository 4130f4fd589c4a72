"""Paper Fig. 9 / §5.5: latency + accuracy under continuous updates, three
configurations: (1) no temp flat index (stale), (2) hybrid + uniform,
(3) hybrid + zipfian (the port of ``benchmarks/update_workload.py``).

The op mix comes from the registered ``update_storm`` scenario
(``repro_torch.scenarios``): the experiment varies only the index policy
and the access distribution on top of that canonical mutation-heavy stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus
from repro_torch.scenarios.registry import get_scenario
from repro_torch.workload.runner import run_workload

SCENARIO = get_scenario("update_storm")


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    rows = []
    n_docs = max(int(48 * scale), 12)
    n_req = max(int(80 * scale), 20)
    configs_ = [
        ("no-flat-uniform", dict(use_hybrid=False), "uniform"),
        ("hybrid-uniform", dict(use_hybrid=True, flat_capacity=64,
                                rebuild_threshold=0.9), "uniform"),
        ("hybrid-zipfian", dict(use_hybrid=True, flat_capacity=64,
                                rebuild_threshold=0.9), "zipfian"),
    ]
    for name, over, dist in configs_:
        corpus = make_corpus(n_docs, seed=1)
        pipe = build_pipeline(corpus, device=device, **over)
        wcfg = dataclasses.replace(
            SCENARIO.mix.config(n_requests=n_req, seed=2), distribution=dist)
        res = run_workload(pipe, corpus, wcfg, query_batch=4)
        lat = res.latencies.get("query", [0.0])
        rows.append({
            "bench": f"update_workload/{name}",
            "qps": res.qps,
            "query_latency_mean_s": float(np.mean(lat)),
            "query_latency_p95_s": float(np.percentile(lat, 95)),
            "rebuilds": pipe.db.stats()["rebuilds"],
            "context_recall": res.quality["context_recall"],
            "exact": res.quality["exact"],
        })
    return rows


if __name__ == "__main__":
    emit(run())
