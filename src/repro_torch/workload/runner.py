"""Drive a workload stream through a RAGPipeline, collecting per-request
latency + quality traces (the harness behind the update/benchmark figures)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec
from repro_torch.metrics.quality import evaluate_traces
from repro_torch.workload.corpus import SyntheticCorpus
from repro_torch.workload.generator import Request, WorkloadConfig, WorkloadGenerator


def gold_chunks_for(db, doc_id: int, answer: str) -> List[int]:
    """Chunk ids of `doc_id` whose text contains the answer string."""
    out = []
    for slot in db.doc_slots.get(doc_id, []):
        c = db.get_chunk(slot)
        if c is not None and answer.lower() in c.text.lower():
            out.append(slot)
    return out


@dataclass
class RunResult:
    latencies: Dict[str, List[float]] = field(default_factory=dict)
    timeline: List[Dict] = field(default_factory=list)   # (t, op, latency)
    quality: Dict[str, float] = field(default_factory=dict)
    qps: float = 0.0

    def mean_latency(self, op: str) -> float:
        xs = self.latencies.get(op, [])
        return sum(xs) / len(xs) if xs else 0.0


def run_workload(pipeline, corpus: SyntheticCorpus,
                 cfg: WorkloadConfig, query_batch: int = 1,
                 evaluate: bool = True) -> RunResult:
    """Replay a workload stream; ``pipeline`` may be a live ``RAGPipeline``
    or a declarative ``PipelineSpec`` (built here, corpus *not* indexed)."""
    if isinstance(pipeline, PipelineSpec):
        pipeline = build(pipeline)
    gen = WorkloadGenerator(cfg, corpus)
    res = RunResult()
    t_start = time.perf_counter()
    n_ops = 0
    pending_queries: List[Request] = []

    def flush_queries():
        nonlocal n_ops
        if not pending_queries:
            return
        t0 = time.perf_counter()
        golds = [gold_chunks_for(pipeline.db, r.gold_doc_id, r.answer)
                 for r in pending_queries]
        pipeline.query([r.question for r in pending_queries],
                       ground_truth=[r.answer for r in pending_queries],
                       gold_chunks=golds)
        dt = (time.perf_counter() - t0) / len(pending_queries)
        for r in pending_queries:
            res.latencies.setdefault("query", []).append(dt)
            res.timeline.append({"t": time.perf_counter() - t_start,
                                 "op": "query", "latency_s": dt})
        n_ops += len(pending_queries)
        pending_queries.clear()

    for req in gen.requests():
        if req.op == "query":
            pending_queries.append(req)
            if len(pending_queries) >= query_batch:
                flush_queries()
            continue
        flush_queries()
        t0 = time.perf_counter()
        if req.op == "insert":
            pipeline.index_documents([(req.doc_id, req.text)], build=False)
        elif req.op == "update":
            pipeline.update_document(req.doc_id, req.text,
                                     version=req.version
                                     or corpus.versions[req.doc_id])
        elif req.op == "removal":
            pipeline.remove_document(req.doc_id)
        dt = time.perf_counter() - t0
        res.latencies.setdefault(req.op, []).append(dt)
        res.timeline.append({"t": time.perf_counter() - t_start,
                             "op": req.op, "latency_s": dt})
        n_ops += 1
    flush_queries()
    wall = time.perf_counter() - t_start
    res.qps = n_ops / wall if wall > 0 else 0.0
    if evaluate:
        res.quality = evaluate_traces(pipeline.traces, pipeline.db)
    return res
