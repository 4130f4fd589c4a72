"""Deterministic hash tokenizer.

No pretrained vocab files exist offline; a stable FNV-1a word hash gives a
reproducible token id space shared by the embedder, reranker and generator.
"""
from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

_WORD = re.compile(r"[a-z0-9]+")

# function words carry no retrieval signal; dropping them keeps the
# bag-of-tokens embeddings and overlap scores discriminative
STOPWORDS = frozenset(
    "a an the is are was were be of what which who where when how why in on "
    "at to for and or it its this that with as by from".split())


def _fnv1a(word: str) -> int:
    h = 0xCBF29CE484222325
    for b in word.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    """word -> stable id in [n_special, vocab)."""

    def __init__(self, vocab_size: int = 32768, n_special: int = 4):
        self.vocab_size = vocab_size
        self.n_special = n_special
        self.pad_id, self.bos_id, self.eos_id, self.sep_id = range(n_special)

    def words(self, text: str) -> List[str]:
        return _WORD.findall(text.lower())

    def content_words(self, text: str) -> List[str]:
        return [w for w in self.words(text) if w not in STOPWORDS]

    def encode(self, text: str, max_len: int = 0) -> List[int]:
        ids = [self.n_special + _fnv1a(w) % (self.vocab_size - self.n_special)
               for w in self.content_words(text)]
        if max_len:
            ids = ids[:max_len]
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        """Padded [n, max_len] int32 batch (pad_id = 0)."""
        out = np.zeros((len(texts), max_len), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_len)
            out[i, :len(ids)] = ids
        return out
