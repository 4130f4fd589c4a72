"""The end-to-end configurable RAG pipeline (paper §3.3, Fig. 1/2): the port
of ``repro.core.pipeline``.

``RAGPipeline`` is a thin shell over the stage graph: components are built
from a declarative ``PipelineSpec`` through the port's registry, and the
query path is the list of composable ``Stage`` objects
(``repro_torch.core.stages``) folded lock-step here. ``device`` reaches every
factory that names a ``device`` parameter (the vector DB, the transformer
embedder, the cross-encoder, the model LLM); ``None`` means the card.

The indexing path's ``insertion`` and ``index_build`` stages end by waiting
for the DB's device: a DB on the card queues its copies and builds
asynchronously, and a stage's host-clock time must include its device work.
The query stages need no such wait: each one's output reaches the host
before its timer stops.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import synchronize
from repro_torch.core import registry
from repro_torch.core.interfaces import (BaseEmbedder, BaseLLM, BaseReranker,
                                         Chunk, DBInstance, StageTrace)
from repro_torch.core.spec import PipelineSpec
from repro_torch.core.stages import (QueryBatch, build_query_stages,
                                     traces_from_batch)
from repro_torch.monitor.monitor import StageTimer


class RAGPipeline:
    def __init__(self, spec: Optional[PipelineSpec] = None,
                 embedder: Optional[BaseEmbedder] = None,
                 db: Optional[DBInstance] = None,
                 reranker: Optional[BaseReranker] = None,
                 llm: Optional[BaseLLM] = None,
                 device=None):
        spec = spec or PipelineSpec()
        self.spec = spec
        self.timer = StageTimer()
        self.traces: List[StageTrace] = []

        self.embedder = embedder or registry.create(
            "embedder", spec.embedder.component, _context={"device": device},
            **spec.embedder.options)
        self.chunker = registry.create(
            "chunker", spec.chunker.component, **spec.chunker.options)
        # context injection: the DB inherits the embedder's dim and the
        # pipeline's device unless the spec says otherwise
        ctx = {"embedder": self.embedder, "dim": self.embedder.dim,
               "device": device}
        self.db = db or registry.create(
            "vectordb", spec.vectordb.component, _context=ctx,
            **spec.vectordb.options)
        if reranker is not None:
            self.reranker = reranker
        else:
            self.reranker = registry.create(
                "reranker", spec.reranker.component, _context=ctx,
                **spec.reranker.options)
        llm_name, llm_opts = spec.llm.component, dict(spec.llm.options)
        if spec.gen.enabled and llm_name == "model":
            # the gen block swaps the lock-step generator for the token-level
            # continuous-batching engine (same arch/prompt/decode options)
            llm_name = "model_engine"
            llm_opts.pop("batch_size", None)   # the slot pool replaces it
            llm_opts.update(
                slots=spec.gen.slots, chunk_tokens=spec.gen.chunk_tokens,
                prefill_chunks_per_step=spec.gen.prefill_chunks_per_step,
                admission=spec.gen.admission)
        self.llm = llm or registry.create("llm", llm_name,
                                          _context={"device": device},
                                          **llm_opts)

        self.tracer = None            # obs.attach_pipeline sets it
        self.stages = build_query_stages(
            self.embedder, self.db, self.reranker, self.llm,
            retrieve_k=spec.retrieve_k, rerank_k=spec.rerank_k,
            timer=self.timer,
            batch_sizes=spec.stage_batch_sizes())

    @classmethod
    def from_spec(cls, spec: PipelineSpec, **component_overrides
                  ) -> "RAGPipeline":
        return cls(spec=spec, **component_overrides)

    # -- indexing path (paper Fig. 1 steps 1-3) -----------------------------

    def index_documents(self, docs: Sequence[Tuple[int, str]],
                        build: bool = True) -> int:
        """Chunk + embed + insert documents [(doc_id, text)]; returns #chunks."""
        chunks: List[Chunk] = []
        with self.timer.stage("chunking"):
            for doc_id, text in docs:
                for start, end, piece in self.chunker.chunk(text):
                    chunks.append(Chunk(-1, doc_id, piece, start, end))
        if not chunks:
            return 0
        with self.timer.stage("embedding"):
            vecs = self.embedder.embed([c.text for c in chunks])
        with self.timer.stage("insertion"):
            self.db.insert(vecs, chunks)
            self._sync_db()
        if build:
            with self.timer.stage("index_build"):
                self.db.build_index()
                self._sync_db()
        return len(chunks)

    def _sync_db(self) -> None:
        """Wait for the DB's queued device work (a DB without a device
        queues none)."""
        dev = getattr(self.db, "device", None)
        if dev is not None:
            synchronize(dev)

    def update_document(self, doc_id: int, text: str, version: int = 1) -> int:
        """Paper §3.2 update op: replace a document's chunks in place."""
        chunks = [Chunk(-1, doc_id, piece, s, e, version=version)
                  for s, e, piece in self.chunker.chunk(text)]
        with self.timer.stage("embedding"):
            vecs = self.embedder.embed([c.text for c in chunks])
        with self.timer.stage("insertion"):
            self.db.update(doc_id, vecs, chunks)
            self._sync_db()
        return len(chunks)

    def remove_document(self, doc_id: int) -> int:
        with self.timer.stage("removal"):
            return self.db.remove(doc_id)

    # -- query path (paper Fig. 1 steps 1-5) --------------------------------

    def query(self, questions: Sequence[str],
              ground_truth: Optional[Sequence[str]] = None,
              gold_chunks: Optional[Sequence[List[int]]] = None
              ) -> List[StageTrace]:
        """Lock-step execution: fold the whole batch through the stage graph
        with a barrier after every stage."""
        batch = QueryBatch(
            questions=list(questions),
            ground_truth=list(ground_truth) if ground_truth else [],
            gold_chunks=[list(g) for g in gold_chunks] if gold_chunks else [])
        for stage in self.stages:
            batch = stage.run(batch)
        traces = traces_from_batch(batch)
        self.traces.extend(traces)
        return traces

    # -- profiling ----------------------------------------------------------

    def breakdown(self) -> Dict[str, float]:
        return self.timer.breakdown()

    def db_stats(self) -> Dict[str, float]:
        return self.db.stats()
