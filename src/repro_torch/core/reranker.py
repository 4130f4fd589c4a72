"""Reranking stage (paper §3.3.3): the port of ``repro.core.reranker``.

``BiEncoderReranker``   — low-latency: scores candidates by cosine between
    independently-encoded query and chunk vectors (re-uses any BaseEmbedder).
``CrossEncoderReranker`` — higher accuracy/cost: jointly encodes
    ``query [SEP] chunk`` pairs through a transformer encoder (the attention
    through the ``flash_attention`` kernel) with a scalar scoring head,
    batched across candidates; random weights from a seed.
``OverlapReranker``      — deterministic lexical-overlap scorer (the
    accuracy oracle for metric tests).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import require_same_device, resolve_device
from repro_torch.core.embedder import (encoder_config, init_matrix,
                                       masked_mean_pool)
from repro_torch.core.interfaces import BaseEmbedder, BaseReranker, Chunk
from repro_torch.core.registry import register
from repro_torch.core.tokenizer import HashTokenizer
from repro_torch.models import transformer


@register("reranker", "bi")
class BiEncoderReranker(BaseReranker):
    def __init__(self, embedder: BaseEmbedder):
        self.embedder = embedder

    def rerank(self, query: str, candidates: Sequence[Chunk], topk: int
               ) -> List[Tuple[Chunk, float]]:
        if not candidates:
            return []
        vecs = self.embedder.embed([query] + [c.text for c in candidates])
        scores = vecs[1:] @ vecs[0]
        order = np.argsort(-scores)[:topk]
        return [(candidates[i], float(scores[i])) for i in order]


@register("reranker", "cross")
class CrossEncoderReranker(BaseReranker):
    """Joint query‖doc scoring — the expensive, accurate family.

    ``model`` and ``head`` ([d_model, 1] float32) replace the seeded draw
    (``repro_torch.convert`` passes the reference's this way)."""

    def __init__(self, d_model: int = 256, n_layers: int = 4,
                 max_len: int = 192, seed: int = 1, batch_size: int = 32,
                 device=None, model: Optional[transformer.Transformer] = None,
                 head: Optional[np.ndarray] = None):
        self.device = resolve_device(device)
        if model is None:
            cfg = encoder_config(d_model=d_model, n_layers=n_layers, dim=1)
            model = transformer.init(cfg, seed, self.device)
        require_same_device("CrossEncoderReranker", model, self.device)
        self.cfg = model.cfg
        self.model = model
        self.tok = HashTokenizer(self.cfg.vocab_size)
        self.max_len = max_len
        self.batch_size = batch_size
        self.head = (init_matrix((self.cfg.d_model, 1), seed + 1, self.device)
                     if head is None else torch.from_numpy(head).to(
                         self.device))

    def rerank(self, query: str, candidates: Sequence[Chunk], topk: int
               ) -> List[Tuple[Chunk, float]]:
        if not candidates:
            return []
        qids = self.tok.encode(query, self.max_len // 3)
        scores = np.zeros(len(candidates), np.float32)
        bs = self.batch_size
        for lo in range(0, len(candidates), bs):
            batch = candidates[lo:lo + bs]
            toks = np.zeros((bs, self.max_len), np.int32)
            for i, c in enumerate(batch):
                ids = qids + [self.tok.sep_id] + self.tok.encode(c.text)
                ids = ids[: self.max_len]
                toks[i, :len(ids)] = ids
            s = _cross_score(self.model, self.head,
                             torch.from_numpy(toks).to(self.device))
            scores[lo:lo + len(batch)] = s[:len(batch)].cpu().numpy()
        order = np.argsort(-scores)[:topk]
        return [(candidates[i], float(scores[i])) for i in order]


@torch.inference_mode()
def _cross_score(model: transformer.Transformer, head: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Encoder forward + mean-pool + linear head -> [B] scores fp32."""
    pooled = masked_mean_pool(model.hidden(tokens, causal=False)[0], tokens)
    return (pooled @ head)[:, 0]


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
