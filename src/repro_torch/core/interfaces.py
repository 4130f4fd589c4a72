"""The paper's Fig. 4 module interfaces.

RAGPerf decomposes the pipeline into five stages behind minimal abstract
interfaces; only inputs/outputs are specified so any implementation can be
swapped via config.  The port's copy of ``repro.core.interfaces``.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Chunk:
    """One indexed unit: text payload + provenance metadata (paper §3.3.1)."""

    chunk_id: int
    doc_id: int
    text: str
    start: int = 0              # char offset in source document
    end: int = 0
    version: int = 0            # bumped on update ops


@dataclass
class SearchResult:
    """Top-k retrieval result for one query."""

    chunk_ids: np.ndarray       # [k] int32 (−1 padding)
    scores: np.ndarray          # [k] float32


class BaseEmbedder(abc.ABC):
    """Declare an embedding model using model name and resource constraint."""

    dim: int

    @abc.abstractmethod
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Embed a set of inputs into [n, dim] float32 unit vectors."""


class DBInstance(abc.ABC):
    """Declare a DB instance with its type and storage location."""

    @abc.abstractmethod
    def insert(self, vectors: np.ndarray, chunks: Sequence[Chunk]) -> None:
        """Insert a batch of chunks into the collection."""

    @abc.abstractmethod
    def remove(self, doc_id: int) -> int:
        """Delete all chunks of a document; returns #removed."""

    @abc.abstractmethod
    def search(self, vectors: np.ndarray, k: int) -> List[SearchResult]:
        """Retrieve similar chunks given a batch of query vectors using ANN."""

    @abc.abstractmethod
    def build_index(self) -> None:
        """(Re)build the main index over all live vectors."""

    @abc.abstractmethod
    def get_chunk(self, chunk_id: int) -> Optional[Chunk]:
        """Payload lookup."""

    def get_chunks(self, chunk_ids: Sequence[int]) -> List[Optional[Chunk]]:
        """Batched payload lookup; backends override with a single round
        trip.  The default falls back to per-id ``get_chunk`` calls."""
        return [self.get_chunk(int(c)) for c in chunk_ids]

    @abc.abstractmethod
    def stats(self) -> Dict[str, float]:
        """Index sizes / memory footprint for the monitor."""


class BaseReranker(abc.ABC):
    """Declare a reranker using model name and resource constraint."""

    @abc.abstractmethod
    def rerank(self, query: str, candidates: Sequence[Chunk], topk: int
               ) -> List[Tuple[Chunk, float]]:
        """Rerank and return the top-k (chunk, score) given query + docs."""


class BaseLLM(abc.ABC):
    """Declare an LLM for generation using model name and resource constraint."""

    @abc.abstractmethod
    def generate(self, prompts: Sequence[str],
                 contexts: Sequence[Sequence[Chunk]]) -> List[str]:
        """Generate final answers given a batch of prompts and contexts."""


@dataclass
class StageTrace:
    """Per-request pipeline trace recorded for metrics (paper §3.3.2/§3.4:
    only chunk ids are stored, not payloads, to bound storage overhead)."""

    query: str = ""
    retrieved_ids: List[int] = field(default_factory=list)
    reranked_ids: List[int] = field(default_factory=list)
    answer: str = ""
    ground_truth: str = ""
    gold_chunk_ids: List[int] = field(default_factory=list)
    latency_s: Dict[str, float] = field(default_factory=dict)
    # attempts the request took through the elastic retry path (1 = clean
    # first pass); latency_s accumulates every attempt's service time
    n_attempts: int = 1
