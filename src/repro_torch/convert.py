"""Carry state from the JAX package's components into the port's.

The port draws its random state (the hash embedder's table, the k-means
initial centroids) with ``torch.Generator`` where the JAX package uses
``jax.random``; the two cannot give the same numbers. To run both packages on
the same state, the reference's state goes across as numpy arrays:

* ``embedder_from_jax`` — a ``repro`` ``HashEmbedder``'s table into the
  port's ``HashEmbedder``;
* ``db_state`` / ``db_from_jax`` — a ``repro`` ``JaxVectorDB``'s vectors,
  masks, payloads, centroids, buckets and quantized state (sq8 codes and
  scale, PQ codes and codebook) into a ``TorchVectorDB``, which then builds
  its own packed mirror (fp32 rows, or PQ codes).

The arguments are read by attribute only: this module imports nothing of the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.interfaces import Chunk
from repro_torch.core.vectordb import DBConfig, TorchVectorDB


def embedder_from_jax(jax_embedder) -> HashEmbedder:
    """The port's ``HashEmbedder`` with the reference's table."""
    table = np.asarray(jax_embedder.table, dtype=np.float32)
    return HashEmbedder(dim=jax_embedder.dim, vocab_size=table.shape[0],
                        table=table.copy())


def _chunk(c) -> Chunk:
    return Chunk(chunk_id=c.chunk_id, doc_id=c.doc_id, text=c.text,
                 start=c.start, end=c.end, version=c.version)


def _array(a, dtype):
    return None if a is None else np.array(a, dtype)


def db_state(jax_db) -> Dict[str, object]:
    """A ``JaxVectorDB``'s index state as numpy arrays and port payloads
    (the argument of ``TorchVectorDB.load_state``)."""
    with jax_db._mu:
        return {
            "vectors": np.array(jax_db.vectors, dtype=np.float32),
            "live": jax_db.live.copy(),
            "indexed": jax_db.indexed.copy(),
            "n_slots": int(jax_db.n_slots),
            "chunks": {int(s): _chunk(c) for s, c in jax_db.chunks.items()},
            "doc_slots": {int(d): [int(s) for s in slots]
                          for d, slots in jax_db.doc_slots.items()},
            "centroids": _array(jax_db.centroids, np.float32),
            "buckets": _array(jax_db.buckets, np.int32),
            "bucket_live": _array(jax_db.bucket_live, bool),
            "sq_codes": _array(jax_db.sq_codes, np.int8),
            "sq_scale": _array(jax_db.sq_scale, np.float32),
            "pq_codes": _array(jax_db.pq_codes, np.int32),
            "pq_codebook": _array(jax_db.pq_codebook, np.float32),
        }


def db_from_jax(jax_db, use_kernel=None, device=None) -> TorchVectorDB:
    """A ``TorchVectorDB`` with the reference's config and state.

    ``use_kernel`` replaces the reference's ladder rung when given."""
    cfg = DBConfig(**{f.name: getattr(jax_db.cfg, f.name)
                      for f in dataclasses.fields(DBConfig)})
    if use_kernel is not None:
        cfg.use_kernel = use_kernel
    db = TorchVectorDB(cfg, device=device)
    db.load_state(db_state(jax_db))
    return db
