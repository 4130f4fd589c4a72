"""The general generator: each closed-loop client's seeded request stream,
from a traffic mix's parameters.

A client's stream depends only on (seed, client), so every run of a seed
offers the same requests whatever the timing; removals of one document come
from one client only (documents are split among the clients by id).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np


def rng_for(*parts) -> np.random.Generator:
    """A numpy generator seeded from ``parts`` (any whole numbers and
    names)."""
    h = hashlib.blake2b(":".join(str(p) for p in parts).encode(),
                        digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def _ops(shares: Dict[str, float]) -> Tuple[List[str], np.ndarray]:
    names = sorted(shares)
    p = np.array([shares[n] for n in names], dtype=np.float64)
    if abs(p.sum() - 1.0) > 1e-9:
        raise ValueError(f"op shares must sum to 1, got {shares}")
    return names, p


class SearchStreams:
    """Search requests (a batch of the seeded query pool), inserts of a
    document of ``rows_per_insert`` rows, and removals of filler
    documents, ``shares`` of each. A client's first search after one of its
    inserts aims its first queries at the rows it inserted."""

    def __init__(self, seed: int, clients: int, shares: Dict[str, float],
                 pool: int, removable: np.ndarray, inserts: int):
        self.names, self.p = _ops(shares)
        self.clients, self.pool, self.inserts = clients, pool, inserts
        self.rng = [rng_for(seed, "search-client", c) for c in range(clients)]
        self.n_search = [0] * clients
        self.n_insert = [0] * clients
        mine = [removable[removable % clients == c] for c in range(clients)]
        self.removals = [m[self.rng[c].permutation(len(m))]
                         for c, m in enumerate(mine)]
        self.n_removed = [0] * clients

    def next(self, c: int) -> Dict[str, object]:
        op = self.names[int(self.rng[c].choice(len(self.names), p=self.p))]
        if op == "insert" and self.n_insert[c] < self.inserts:
            j = self.n_insert[c]
            self.n_insert[c] += 1
            return {"op": "insert", "j": j}
        if op == "removal" and self.n_removed[c] < len(self.removals[c]):
            d = int(self.removals[c][self.n_removed[c]])
            self.n_removed[c] += 1
            return {"op": "removal", "doc": d}
        j = self.n_search[c]
        self.n_search[c] += 1
        return {"op": "search", "pool": (c + j * self.clients) % self.pool}
