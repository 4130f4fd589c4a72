"""Embedding stage (paper §3.3.1): the hash embedder.

``HashEmbedder`` is a deterministic bag-of-tokens embedding: rows of a fixed
random Gaussian table, mean-pooled and L2-normalized. It stays on the host,
in numpy, as the JAX package's does (``repro.core.embedder.HashEmbedder``),
so the same table gives bit-identical vectors in both packages. The JAX
package draws its table with ``jax.random``, which torch cannot reproduce:
the port draws its own from a ``torch.Generator``, and a parity run passes
the reference's table in (``repro_torch.convert.embedder_from_jax``).

The transformer embedder waits for the model port (ROADMAP.md queue 1).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.interfaces import BaseEmbedder
from repro_torch.core.registry import register
from repro_torch.core.tokenizer import HashTokenizer


@register("embedder", "hash")
class HashEmbedder(BaseEmbedder):
    """Deterministic token-bag embedding: E[token] rows from a fixed random
    Gaussian, mean-pooled, L2-normalized.  Zero model FLOPs; pure lookup.

    ``table`` ([vocab_size, dim] float32) replaces the seeded draw."""

    def __init__(self, dim: int = 384, vocab_size: int = 32768, seed: int = 0,
                 table: Optional[np.ndarray] = None):
        self.dim = dim
        self.tok = HashTokenizer(vocab_size)
        if table is None:
            gen = torch.Generator().manual_seed(seed)
            table = (torch.randn((vocab_size, dim), generator=gen).numpy()
                     / math.sqrt(dim))
        if table.shape != (vocab_size, dim) or table.dtype != np.float32:
            raise ValueError(f"table must be float32 [{vocab_size}, {dim}], "
                             f"got {table.dtype} {table.shape}")
        self.table = table

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)
            if ids:
                v = self.table[np.asarray(ids)].mean(0)
                out[i] = v / (np.linalg.norm(v) + 1e-9)
        return out
