"""Composable query-path stages (the stage graph behind ``RAGPipeline``).

Each stage is a first-class schedulable unit with a uniform
``run(batch) -> batch`` interface over a shared ``QueryBatch`` envelope:

    EmbedStage     questions            -> qvecs
    RetrieveStage  qvecs                -> results + candidates
    RerankStage    candidates           -> contexts + reranked_ids
    GenerateStage  questions + contexts -> answers

The lock-step ``RAGPipeline.query`` folds a batch through the stage list
with hard barriers; the ``StagedExecutor`` and ``ElasticExecutor`` in
``repro_torch.serving`` run the *same* stage objects as pipelined workers
and replica pools.  Every path produces identical outputs — stage
composition changes scheduling, never semantics.

Every ``run`` records wall time into the shared ``StageTimer`` *and* a
per-request latency share into the batch, which lands in
``StageTrace.latency_s`` (paper §3.3.2 trace format).
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.interfaces import (BaseEmbedder, BaseLLM,
                                         BaseReranker, Chunk, DBInstance,
                                         SearchResult, StageTrace)
from repro_torch.monitor.monitor import StageTimer


@dataclass
class QueryBatch:
    """The envelope a query batch accumulates as it flows through stages."""

    questions: List[str]
    ground_truth: List[str] = field(default_factory=list)
    gold_chunks: List[List[int]] = field(default_factory=list)
    qvecs: Optional[np.ndarray] = None              # [n, dim] after embed
    results: Optional[List[SearchResult]] = None    # after retrieve
    candidates: Optional[List[List[Chunk]]] = None  # after retrieve
    contexts: Optional[List[List[Chunk]]] = None    # after rerank
    reranked_ids: Optional[List[List[int]]] = None  # after rerank
    answers: Optional[List[str]] = None             # after generate
    latency_s: Dict[str, float] = field(default_factory=dict)  # per-request

    def __post_init__(self):
        n = len(self.questions)
        if not self.ground_truth:
            self.ground_truth = [""] * n
        if not self.gold_chunks:
            self.gold_chunks = [[] for _ in range(n)]

    def __len__(self) -> int:
        return len(self.questions)


class Stage(abc.ABC):
    """One schedulable pipeline stage: ``run(batch) -> batch``.

    ``batch_size`` is the stage's preferred micro-batch for the pipelined
    executor (0 = executor default); the stage itself processes whatever
    batch it is handed.
    """

    name: str = "stage"

    def __init__(self, batch_size: int = 0,
                 timer: Optional[StageTimer] = None):
        self.batch_size = batch_size
        self.timer = timer
        # optional obs.Tracer for lock-step runs (attach_pipeline); the
        # staged/elastic executors trace per item themselves and leave this
        # None to avoid double-recording service time
        self.tracer = None

    def run(self, batch: QueryBatch) -> QueryBatch:
        t0 = time.perf_counter()
        if self.timer is not None:
            with self.timer.stage(self.name):
                self._apply(batch)
        else:
            self._apply(batch)
        dt = time.perf_counter() - t0
        if len(batch):
            batch.latency_s[self.name] = (
                batch.latency_s.get(self.name, 0.0) + dt / len(batch))
        tr = self.tracer
        if tr is not None:
            te = tr.now()
            tr.add_span(self.name, te - dt, te, cat="service",
                        tid=self.name, n=len(batch))
        return batch

    def replica_copy(self) -> "Stage":
        """A stage instance safe for one extra replica worker.

        Stages over shared thread-safe components return ``self``; the
        generation stage overrides this to hand each replica its own
        ``ModelLLM`` view (``clone``).
        """
        return self

    @abc.abstractmethod
    def _apply(self, batch: QueryBatch) -> None:
        """Fill in this stage's output fields on the batch, in place."""


class EmbedStage(Stage):
    name = "query_embed"

    def __init__(self, embedder: BaseEmbedder, **kw):
        super().__init__(**kw)
        self.embedder = embedder

    def _apply(self, batch: QueryBatch) -> None:
        batch.qvecs = self.embedder.embed(batch.questions)


class RetrieveStage(Stage):
    name = "retrieval"

    def __init__(self, db: DBInstance, retrieve_k: int, **kw):
        super().__init__(**kw)
        self.db = db
        self.retrieve_k = retrieve_k

    def _apply(self, batch: QueryBatch) -> None:
        assert batch.qvecs is not None, "RetrieveStage needs EmbedStage output"
        batch.results = self.db.search(batch.qvecs, self.retrieve_k)
        # one batched payload fetch for the whole candidate set
        rows = [[int(c) for c in r.chunk_ids if c >= 0] for r in batch.results]
        flat = self.db.get_chunks([c for row in rows for c in row])
        batch.candidates = []
        pos = 0
        for row in rows:
            cands = flat[pos:pos + len(row)]
            pos += len(row)
            batch.candidates.append([c for c in cands if c is not None])


class RerankStage(Stage):
    """Reranks candidates down to ``rerank_k``; with no reranker the stage is
    a truncation passthrough (candidate order is the retrieval order)."""

    name = "rerank"

    def __init__(self, reranker: Optional[BaseReranker], rerank_k: int, **kw):
        super().__init__(**kw)
        self.reranker = reranker
        self.rerank_k = rerank_k

    def _apply(self, batch: QueryBatch) -> None:
        assert batch.candidates is not None, \
            "RerankStage needs RetrieveStage output"
        batch.contexts, batch.reranked_ids = [], []
        if self.reranker is None:
            for cands in batch.candidates:
                ctx = cands[: self.rerank_k]
                batch.contexts.append(ctx)
                batch.reranked_ids.append([c.chunk_id for c in ctx])
            return
        for q, cands in zip(batch.questions, batch.candidates):
            top = self.reranker.rerank(q, cands, self.rerank_k)
            batch.contexts.append([c for c, _ in top])
            batch.reranked_ids.append([c.chunk_id for c, _ in top])


class GenerateStage(Stage):
    name = "generation"

    def __init__(self, llm: BaseLLM, **kw):
        super().__init__(**kw)
        self.llm = llm

    def _apply(self, batch: QueryBatch) -> None:
        assert batch.contexts is not None, \
            "GenerateStage needs RerankStage output"
        batch.answers = self.llm.generate(batch.questions, batch.contexts)

    def replica_copy(self) -> "GenerateStage":
        """Per-replica generators: an LLM exposing ``clone()`` gets a copy
        per worker: a ``ModelLLM`` a view (the same weight tensors and
        thread-safe GenStats, its own decode length knob), an ``EngineLLM``
        a warm engine (the same weights, GenStats and counters, its own KV
        slot pool and knob). That is what makes replicating the generation
        stage legal."""
        if not hasattr(self.llm, "clone"):
            return self
        return GenerateStage(self.llm.clone(), batch_size=self.batch_size,
                             timer=self.timer)


def traces_from_batch(batch: QueryBatch,
                      latency_s: Optional[List[Dict[str, float]]] = None,
                      n_attempts: Optional[Sequence[int]] = None
                      ) -> List[StageTrace]:
    """Assemble the per-request §3.3.2 traces from a fully-processed batch.

    ``latency_s`` overrides the batch-shared latency dict with per-request
    dicts (the pipelined executor tracks latency per item, not per batch);
    ``n_attempts`` carries the elastic retry count per request (default 1).
    """
    assert batch.answers is not None, "batch has not run all stages"
    traces = []
    for i, q in enumerate(batch.questions):
        traces.append(StageTrace(
            query=q,
            retrieved_ids=[int(c) for c in batch.results[i].chunk_ids
                           if c >= 0],
            reranked_ids=batch.reranked_ids[i],
            answer=batch.answers[i],
            ground_truth=batch.ground_truth[i],
            gold_chunk_ids=list(batch.gold_chunks[i]),
            latency_s=latency_s[i] if latency_s else dict(batch.latency_s),
            n_attempts=n_attempts[i] if n_attempts else 1,
        ))
    return traces


def build_query_stages(embedder: BaseEmbedder, db: DBInstance,
                       reranker: Optional[BaseReranker], llm: BaseLLM,
                       retrieve_k: int, rerank_k: int,
                       timer: Optional[StageTimer] = None,
                       batch_sizes: Optional[Dict[str, int]] = None
                       ) -> List[Stage]:
    """The canonical 4-stage query graph, wired to shared components.

    ``batch_sizes`` maps stage names to the pipelined executor's per-stage
    micro-batch (0/absent = executor default).
    """
    bs = batch_sizes or {}
    return [
        EmbedStage(embedder, timer=timer,
                   batch_size=bs.get(EmbedStage.name, 0)),
        RetrieveStage(db, retrieve_k, timer=timer,
                      batch_size=bs.get(RetrieveStage.name, 0)),
        RerankStage(reranker, rerank_k, timer=timer,
                    batch_size=bs.get(RerankStage.name, 0)),
        GenerateStage(llm, timer=timer,
                      batch_size=bs.get(GenerateStage.name, 0)),
    ]
