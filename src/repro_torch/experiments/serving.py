"""Serving experiment: QPS-vs-tail-latency sweep (open loop) + closed-loop
capacity point (the port of ``benchmarks/serving.py``).

Sweeps offered QPS through the continuous-batching executor and reports the
achieved QPS, p50/p95/p99 latency, and SLO goodput at each point — the
saturation curve that separates serving systems (queueing theory says p99
explodes as offered load approaches capacity; this experiment draws that
knee).  A closed-loop run at fixed concurrency gives the capacity reference.

``python -m repro_torch.experiments.serving --smoke --device cpu`` emits
the sweep as JSON.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, make_corpus
from repro_torch.serving.arrival import ArrivalConfig
from repro_torch.serving.batcher import BatchPolicy
from repro_torch.serving.harness import (ServingConfig, ServingHarness,
                                         warm_up)
from repro_torch.workload.generator import WorkloadConfig

SLO_MS = 250.0


def _run_point(corpus_docs: int, n_requests: int, *, mode: str,
               qps: float = 50.0, concurrency: int = 4,
               update_frac: float = 0.1, max_batch: int = 8,
               seed: int = 0, device="cuda") -> Dict[str, float]:
    corpus = make_corpus(corpus_docs, seed=seed)
    pipe = build_pipeline(corpus, index_type="flat", use_hybrid=True,
                          device=device)
    warm_up(pipe)                          # first-call costs outside the clock
    wcfg = WorkloadConfig(query_frac=1.0 - update_frac,
                          update_frac=update_frac,
                          n_requests=n_requests, seed=seed)
    scfg = ServingConfig(
        arrival=ArrivalConfig(mode=mode, process="poisson", target_qps=qps,
                              n_requests=n_requests, concurrency=concurrency,
                              seed=seed),
        policy=BatchPolicy(max_batch=max_batch, max_wait_s=0.01),
        slo_ms=SLO_MS)
    res = ServingHarness(pipe, corpus, wcfg, scfg).run()
    return res.summary


def sweep(scale: float = 1.0, device="cuda") -> List[Dict[str, float]]:
    device = resolve_device(device)
    n_docs = max(16, int(32 * scale))
    n_req = max(30, int(80 * scale))
    points = []
    for qps in (25.0, 50.0, 100.0, 200.0):
        s = _run_point(n_docs, n_req, mode="open", qps=qps, device=device)
        points.append({
            "mode": "open",
            "offered_qps": qps,
            "achieved_qps": s.get("achieved_qps", 0.0),
            "p50_ms": s.get("p50_latency_ms", 0.0),
            "p95_ms": s.get("p95_latency_ms", 0.0),
            "p99_ms": s.get("p99_latency_ms", 0.0),
            "p95_queue_wait_ms": s.get("p95_queue_wait_ms", 0.0),
            "mean_batch_size": s.get("mean_batch_size", 1.0),
            "slo_attainment": s.get("slo_attainment", 0.0),
            "goodput_qps": s.get("goodput_qps", 0.0),
        })
    s = _run_point(n_docs, n_req, mode="closed", concurrency=4,
                   device=device)
    points.append({
        "mode": "closed", "concurrency": 4.0,
        "achieved_qps": s.get("achieved_qps", 0.0),
        "p50_ms": s.get("p50_latency_ms", 0.0),
        "p99_ms": s.get("p99_latency_ms", 0.0),
        "goodput_qps": s.get("goodput_qps", 0.0),
    })
    return points


def run(scale: float = 1.0, device="cuda") -> List[Dict]:
    """``experiments.run`` entry point: the QPS sweep as CSV rows."""
    rows = []
    for p in sweep(scale, device):
        tag = (f"serving_open_q{int(p['offered_qps'])}"
               if p["mode"] == "open" else "serving_closed_c4")
        row = {"bench": tag}
        row.update({k: float(v) for k, v in p.items()
                    if isinstance(v, (int, float))})
        rows.append(row)
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
    doc = {"slo_ms": SLO_MS, "sweep": points}
    text = json.dumps(doc, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
