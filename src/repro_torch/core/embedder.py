"""Embedding stage (paper §3.3.1): the port of ``repro.core.embedder``.

``TransformerEmbedder`` is a bidirectional encoder (the dense transformer's
layers run non-causally, the attention through the ``flash_attention``
kernel) with masked mean pooling, a projection and an L2 norm: the
performance-realistic path, with random weights from a seed.

``HashEmbedder`` is a deterministic bag-of-tokens embedding: rows of a fixed
random Gaussian table, mean-pooled and L2-normalized. It stays on the host,
in numpy, as the JAX package's does (``repro.core.embedder.HashEmbedder``),
so the same table gives bit-identical vectors in both packages. The JAX
package draws its table with ``jax.random``, which torch cannot reproduce:
the port draws its own from a ``torch.Generator``, and a parity run passes
the reference's table in (``repro_torch.convert.embedder_from_jax``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import require_same_device, resolve_device
from repro_torch.core.interfaces import BaseEmbedder
from repro_torch.core.registry import register
from repro_torch.core.tokenizer import HashTokenizer
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def encoder_config(d_model: int = 256, n_layers: int = 4, n_heads: int = 4,
                   dim: int = 384, vocab: int = 32768) -> ModelConfig:
    return ModelConfig(
        name=f"embedder-{dim}", family="dense", n_layers=n_layers,
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=4 * d_model, vocab_size=vocab, activation="gelu",
        rope_type="rope", rope_theta=10000.0, remat="none")


def init_matrix(shape, seed: int, device) -> torch.Tensor:
    """A ``[in, out]`` fp32 matrix, truncated normal with fan-in scale,
    drawn on ``device`` from ``seed`` (the embedder's projection and the
    cross-encoder's head)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    transformer.dense_init_(w, gen)
    return w


def masked_mean_pool(x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean of ``x [B,S,D]`` in fp32 over the non-pad tokens (id > 0)."""
    mask = (tokens > 0).float()[..., None]
    return (x.float() * mask).sum(1) / mask.sum(1).clamp(min=1.0)


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


@register("embedder", "transformer")
class TransformerEmbedder(BaseEmbedder):
    """Bidirectional transformer encoder + masked mean pool + projection.

    ``model`` and ``proj`` ([d_model, dim] float32) replace the seeded
    draw (``repro_torch.convert`` passes the reference's this way)."""

    def __init__(self, dim: int = 384, d_model: int = 256, n_layers: int = 4,
                 max_len: int = 128, seed: int = 0, batch_size: int = 64,
                 device=None, model: Optional[transformer.Transformer] = None,
                 proj: Optional[np.ndarray] = None):
        self.dim = dim
        self.max_len = max_len
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if model is None:
            cfg = encoder_config(d_model=d_model, n_layers=n_layers, dim=dim)
            model = transformer.init(cfg, seed, self.device)
        require_same_device("TransformerEmbedder", model, self.device)
        self.cfg = model.cfg
        self.model = model
        self.tok = HashTokenizer(self.cfg.vocab_size)
        self.proj = (init_matrix((self.cfg.d_model, dim), seed + 1,
                                 self.device) if proj is None
                     else torch.from_numpy(proj).to(self.device))

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for lo in range(0, len(texts), self.batch_size):
            batch = texts[lo:lo + self.batch_size]
            tokens = self.tok.encode_batch(batch, self.max_len)
            # pad the batch dim to a fixed shape, as the reference does
            n = len(batch)
            if n < self.batch_size:
                tokens = np.pad(tokens, ((0, self.batch_size - n), (0, 0)))
            vecs = _encode_fn(self.model, self.proj,
                              torch.from_numpy(tokens).to(self.device))
            out[lo:lo + n] = vecs[:n].cpu().numpy()
        return out


@torch.inference_mode()
def _encode_fn(model: transformer.Transformer, proj: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """Non-causal encoder forward -> unit vectors [B, dim] fp32. The model
    attends to the pad keys too, as the reference's does; only the pooling
    masks them."""
    pooled = masked_mean_pool(model.hidden(tokens, causal=False)[0], tokens)
    v = pooled @ proj
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-9)
