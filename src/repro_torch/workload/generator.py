"""Workload generator (paper §3.2, Fig. 3).

A workload is a stream of Query / Insert / Update / Removal operations drawn
from a configured mix, with target documents selected by a Uniform or
Zipfian access distribution.  Update requests go through the dynamic
ground-truth module of ``SyntheticCorpus`` (fact edit + synthesized QA pair);
the new question is shuffled into the question pool so later queries verify
the pipeline retrieves *fresh* data rather than stale chunks.

The generator is a pure function of (config, seed, step): replaying the same
seed reproduces the same request stream bit-for-bit, which is what makes
checkpoint/restart of a benchmark run deterministic (DESIGN.md §6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.workload.corpus import SyntheticCorpus


@dataclass
class Request:
    op: str                        # query | insert | update | removal
    step: int
    doc_id: int = -1
    text: str = ""                 # document payload (insert/update)
    question: str = ""             # query payload
    answer: str = ""               # ground truth for queries
    gold_doc_id: int = -1          # document containing the answer
    version: int = 0               # document version after an update op


@dataclass
class WorkloadConfig:
    query_frac: float = 0.9
    insert_frac: float = 0.0
    update_frac: float = 0.1
    removal_frac: float = 0.0
    distribution: str = "uniform"  # uniform | zipfian
    zipf_s: float = 1.2            # Zipf exponent (hotspot skew)
    n_requests: int = 1000
    seed: int = 0

    def __post_init__(self):
        total = (self.query_frac + self.insert_frac + self.update_frac
                 + self.removal_frac)
        assert abs(total - 1.0) < 1e-6, f"op mix must sum to 1, got {total}"


class WorkloadGenerator:
    def __init__(self, cfg: WorkloadConfig, corpus: SyntheticCorpus):
        self.cfg = cfg
        self.corpus = corpus
        self.rng = np.random.default_rng(cfg.seed)
        # question pool: (question, answer, doc_id); seeded from base facts
        self.question_pool: List[Tuple[str, str, int]] = []
        for d in range(corpus.cfg.n_docs):
            q, a = corpus.question_for(d, self.rng)
            self.question_pool.append((q, a, d))
        self._perm: Optional[np.ndarray] = None

    # -- access distribution -------------------------------------------------

    def _pick_doc(self) -> int:
        n = self.corpus.cfg.n_docs
        if self.cfg.distribution == "uniform":
            return int(self.rng.integers(0, n))
        # Zipfian over a fixed permutation so the hot set is stable
        if self._perm is None or len(self._perm) < n:
            perm_rng = np.random.default_rng(self.cfg.seed + 7)
            self._perm = perm_rng.permutation(n)
        ranks = np.arange(1, n + 1, dtype=np.float64)
        probs = ranks ** -self.cfg.zipf_s
        probs /= probs.sum()
        return int(self._perm[self.rng.choice(n, p=probs)])

    def _pick_question(self) -> Tuple[str, str, int]:
        # bias towards the access distribution's hot documents
        doc = self._pick_doc()
        cands = [t for t in self.question_pool if t[2] == doc]
        if cands:
            return cands[int(self.rng.integers(0, len(cands)))]
        return self.question_pool[int(self.rng.integers(0, len(self.question_pool)))]

    # -- the stream ------------------------------------------------------------

    def requests(self) -> Iterator[Request]:
        cfg = self.cfg
        ops = ["query", "insert", "update", "removal"]
        probs = [cfg.query_frac, cfg.insert_frac, cfg.update_frac,
                 cfg.removal_frac]
        removed: set = set()
        for step in range(cfg.n_requests):
            op = str(self.rng.choice(ops, p=probs))
            if op == "query":
                q, a, d = self._pick_question()
                yield Request("query", step, doc_id=d, question=q, answer=a,
                              gold_doc_id=d)
            elif op == "insert":
                doc_id, text = self.corpus.new_document()
                q, a = self.corpus.question_for(doc_id, self.rng)
                self.question_pool.append((q, a, doc_id))
                yield Request("insert", step, doc_id=doc_id, text=text)
            elif op == "update":
                doc_id = self._pick_doc()
                if doc_id in removed:
                    continue
                text, q, a = self.corpus.make_update(doc_id, self.rng)
                # drop stale questions about this doc, add the fresh one
                self.question_pool = [t for t in self.question_pool
                                      if t[2] != doc_id]
                self.question_pool.append((q, a, doc_id))
                yield Request("update", step, doc_id=doc_id, text=text,
                              question=q, answer=a, gold_doc_id=doc_id,
                              version=self.corpus.versions[doc_id])
            else:
                doc_id = self._pick_doc()
                if doc_id in removed:
                    continue
                removed.add(doc_id)
                self.question_pool = [t for t in self.question_pool
                                      if t[2] != doc_id]
                yield Request("removal", step, doc_id=doc_id)
