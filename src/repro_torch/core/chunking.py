"""Document chunkers (paper §3.3.1): fixed-length, separator-based, and
semantic-boundary, each with configurable overlap.  Offsets are recorded so
chunk provenance can be traced back to the source document."""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core.registry import register

Span = Tuple[int, int, str]   # (start, end, text)


def fixed_length_chunks(text: str, size: int, overlap: int = 0) -> List[Span]:
    assert 0 <= overlap < size
    out, step = [], size - overlap
    for start in range(0, max(len(text) - overlap, 1), step):
        piece = text[start:start + size]
        if piece.strip():
            out.append((start, start + len(piece), piece))
    return out


def separator_chunks(text: str, max_chars: int, overlap_sents: int = 0,
                     separator: str = r"(?<=[.!?])\s+") -> List[Span]:
    """Sentence/paragraph packing: greedy fill up to max_chars."""
    sents: List[Span] = []
    pos = 0
    for piece in re.split(separator, text):
        if not piece:
            continue
        start = text.find(piece, pos)
        if start < 0:
            start = pos
        sents.append((start, start + len(piece), piece))
        pos = start + len(piece)
    out: List[Span] = []
    cur: List[Span] = []
    cur_len = 0
    for s in sents:
        if cur and cur_len + len(s[2]) > max_chars:
            out.append((cur[0][0], cur[-1][1], " ".join(c[2] for c in cur)))
            cur = cur[-overlap_sents:] if overlap_sents else []
            cur_len = sum(len(c[2]) for c in cur)
        cur.append(s)
        cur_len += len(s[2])
    if cur:
        out.append((cur[0][0], cur[-1][1], " ".join(c[2] for c in cur)))
    return out


def semantic_chunks(text: str, max_chars: int) -> List[Span]:
    """Boundary detection via lexical-cohesion drop between adjacent sentences
    (lightweight stand-in for the paper's small-LM boundary model): split when
    the Jaccard similarity of adjacent sentence vocabularies dips below the
    running mean."""
    sent_spans = separator_chunks(text, max_chars=1, overlap_sents=0)
    if len(sent_spans) <= 1:
        return separator_chunks(text, max_chars)
    vocabs = [set(s[2].lower().split()) for s in sent_spans]
    sims = []
    for a, b in zip(vocabs, vocabs[1:]):
        union = len(a | b) or 1
        sims.append(len(a & b) / union)
    mean_sim = sum(sims) / len(sims)
    out: List[Span] = []
    cur: List[Span] = [sent_spans[0]]
    for i, s in enumerate(sent_spans[1:]):
        cur_len = sum(len(c[2]) for c in cur)
        if sims[i] < 0.5 * mean_sim or cur_len + len(s[2]) > max_chars:
            out.append((cur[0][0], cur[-1][1], " ".join(c[2] for c in cur)))
            cur = []
        cur.append(s)
    if cur:
        out.append((cur[0][0], cur[-1][1], " ".join(c[2] for c in cur)))
    return out


CHUNKERS = {
    "fixed": fixed_length_chunks,
    "separator": separator_chunks,
    "semantic": semantic_chunks,
}


def chunk_document(text: str, method: str = "separator", size: int = 512,
                   overlap: int = 0) -> List[Span]:
    if method == "fixed":
        return fixed_length_chunks(text, size, overlap)
    if method == "separator":
        return separator_chunks(text, size, overlap)
    if method == "semantic":
        return semantic_chunks(text, size)
    raise ValueError(f"unknown chunking method {method!r}")


@dataclass
class Chunker:
    """A chunking policy bound to its knobs: the pipeline's chunking
    component (``chunk(text) -> [(start, end, piece)]``)."""

    method: str = "separator"
    size: int = 512
    overlap: int = 0

    def chunk(self, text: str) -> List[Span]:
        return chunk_document(text, self.method, self.size, self.overlap)


@register("chunker", "fixed")
def _fixed_chunker(size: int = 512, overlap: int = 0) -> Chunker:
    return Chunker("fixed", size, overlap)


@register("chunker", "separator")
def _separator_chunker(size: int = 512, overlap: int = 0) -> Chunker:
    return Chunker("separator", size, overlap)


@register("chunker", "semantic")
def _semantic_chunker(size: int = 512, overlap: int = 0) -> Chunker:
    # the semantic chunker finds its own boundaries; overlap is accepted for
    # spec uniformity but has no effect
    return Chunker("semantic", size, 0)
