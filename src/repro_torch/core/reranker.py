"""Reranking stage (paper §3.3.3): the port of the overlap reranker and the
``none`` passthrough of ``repro.core.reranker``.

``OverlapReranker`` is the deterministic lexical-overlap scorer (the accuracy
oracle for metric tests). The bi- and cross-encoder rerankers wait for the
model port (ROADMAP.md queue 1).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from repro_torch.core.interfaces import BaseReranker, Chunk
from repro_torch.core.registry import register
from repro_torch.core.tokenizer import HashTokenizer


@register("reranker", "overlap")
class OverlapReranker(BaseReranker):
    """IDF-weighted lexical overlap (BM25-lite): deterministic quality oracle.

    Document frequencies come from the candidate set itself, so words shared
    by every candidate (filler) score ~0 while the discriminative query terms
    (entity / attribute) dominate."""

    def __init__(self):
        self.tok = HashTokenizer()

    def rerank(self, query: str, candidates: Sequence[Chunk], topk: int
               ) -> List[Tuple[Chunk, float]]:
        qset = set(self.tok.content_words(query))
        csets = [set(self.tok.content_words(c.text)) for c in candidates]
        n = max(len(candidates), 1)
        df = {w: sum(w in cs for cs in csets) for w in qset}
        idf = {w: math.log(1.0 + n / (1.0 + df[w])) for w in qset}
        scored = []
        for c, cs in zip(candidates, csets):
            s = sum(idf[w] for w in qset & cs)
            # mild length normalization so padded chunks don't win on bulk
            s /= math.sqrt(1.0 + len(cs) / 64.0)
            scored.append((c, s))
        scored.sort(key=lambda t: -t[1])
        return scored[:topk]


@register("reranker", "none")
def _no_reranker():
    """The rerank stage degrades to a truncation passthrough."""
    return None
