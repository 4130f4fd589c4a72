"""Deterministic training data: the port of ``repro.train.data``.

Batches are a pure function of (seed, step, shard): a restart at step N
regenerates the stream from N, so checkpoint/restart is bitwise
reproducible with no loader state to persist. Batches are numpy arrays,
bit for bit the reference's for the same seed, step and shard; the train
loop moves them to the device.

Two sources:
  * ``synthetic`` — a token stream with Zipf unigram statistics;
  * ``corpus``    — tokenized ``SyntheticCorpus`` documents (the RAG
    knowledge base doubles as training text).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.tokenizer import HashTokenizer
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"      # synthetic | corpus
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    zipf_s: float = 1.1


def synthetic_batch(cfg: DataConfig, vocab: int, step: int,
                    shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """[global_batch / n_shards, seq_len] token/label arrays for one step."""
    assert cfg.global_batch % n_shards == 0
    b = cfg.global_batch // n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    # Zipf-distributed unigrams, capped at vocab
    toks = rng.zipf(cfg.zipf_s, size=(b, cfg.seq_len + 1)).astype(np.int64)
    toks = (toks - 1) % vocab
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


class CorpusDataSource:
    """Token stream over SyntheticCorpus documents."""

    def __init__(self, corpus, cfg: DataConfig, vocab: int):
        self.cfg = cfg
        tok = HashTokenizer(vocab)
        ids = []
        for _, text in corpus.all_documents():
            ids.extend(tok.encode(text))
            ids.append(tok.eos_id)
        self.stream = np.asarray(ids, dtype=np.int32)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        n = len(self.stream) - cfg.seq_len - 1
        starts = rng.integers(0, max(n, 1), size=b)
        toks = np.stack([self.stream[s:s + cfg.seq_len + 1] for s in starts])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_iterator(cfg: DataConfig, model_cfg: ModelConfig,
                   corpus=None, start_step: int = 0,
                   shard: int = 0, n_shards: int = 1
                   ) -> Iterator[Dict[str, np.ndarray]]:
    src: Optional[CorpusDataSource] = None
    if cfg.source == "corpus":
        assert corpus is not None
        src = CorpusDataSource(corpus, cfg, model_cfg.vocab_size)
    step = start_step
    while True:
        if src is not None:
            yield src.batch(step, shard, n_shards)
        else:
            yield synthetic_batch(cfg, model_cfg.vocab_size, step,
                                  shard, n_shards)
        step += 1
