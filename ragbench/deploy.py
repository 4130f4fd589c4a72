"""Build one configuration's deployment on the program under test.

The DB is the program's ``torch_fused`` vector DB, filled with rows the
benchmark draws on the device from the seed (clustered unit vectors, as the
collection they stand for), then built, then given its fresh rows and its
removals. The search mix's query pool and inserted rows are drawn from the
seed as well. Everything the program is handed is recorded
(``ragbench.record``).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ragbench.cell import Cell
from ragbench.record import Log

FILLER_DOC0 = 1 << 24          # filler documents' ids start here
INSERT_DOC0 = 1 << 26          # documents the window inserts


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one draw of a run (any whole ``seed``)."""
    h = hashlib.blake2b(":".join(str(p) for p in (seed, *parts)).encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def draw_rows(cfg: Dict[str, Any], seed: int, device) -> torch.Tensor:
    """The filler rows, ``db_rows + fresh_rows`` clustered unit vectors:
    a row is one of ``centers`` seeded unit centres plus ``row_noise`` of a
    unit noise vector, renormalised."""
    db = cfg["db"]
    n = cfg["db_rows"] + db["fresh_rows"]
    dim = db["dim"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "rows"))
    centers = torch.nn.functional.normalize(torch.randn(
        db["centers"], dim, generator=gen, device=device), dim=1)
    pick = torch.randint(centers.shape[0], (n,), generator=gen, device=device)
    noise = torch.randn(n, dim, generator=gen, device=device)
    return torch.nn.functional.normalize(
        centers[pick] + db["row_noise"] * torch.nn.functional.normalize(
            noise, dim=1), dim=1)


def removed_docs(cfg: Dict[str, Any], seed: int) -> np.ndarray:
    """The filler documents removed at set-up (``removed_doc_share``)."""
    db = cfg["db"]
    n_docs = (cfg["db_rows"] + db["fresh_rows"]) // db["rows_per_doc"]
    rng = np.random.default_rng(sub_seed(seed, "removed"))
    k = int(n_docs * db["removed_doc_share"])
    return np.sort(rng.permutation(n_docs)[:k]) + FILLER_DOC0


def live_filler(cfg: Dict[str, Any], seed: int, device) -> torch.Tensor:
    """Indices of the filler rows whose documents survive set-up."""
    db = cfg["db"]
    n = cfg["db_rows"] + db["fresh_rows"]
    gone = torch.zeros(n // db["rows_per_doc"] + 1, dtype=torch.bool,
                       device=device)
    gone[torch.as_tensor(removed_docs(cfg, seed) - FILLER_DOC0,
                         device=device)] = True
    return torch.nonzero(~gone[torch.arange(n, device=device)
                               // db["rows_per_doc"]])[:, 0]


@torch.no_grad()
def search_pools(cell: Cell, seed: int, rows: torch.Tensor, device):
    """The search mix's seeded host pools: ``pool_requests`` batches of
    ``queries_per_request`` unit queries, each a live row plus
    ``query_noise`` of Gaussian noise, renormalised; and each client's
    ``inserts_per_client`` documents of ``rows_per_insert`` rows, drawn as
    the filler rows are (a live row plus ``row_noise`` of unit noise)."""
    mix = cell.mix
    P, nq = mix["pool_requests"], mix["queries_per_request"]
    dim = rows.shape[1]
    live = live_filler(cell.cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "queries"))
    pool = np.empty((P, nq, dim), dtype=np.float32)
    step = max(1, (1 << 16) // nq)
    for a in range(0, P, step):
        b = min(a + step, P)
        at = live[torch.randint(len(live), ((b - a) * nq,), generator=gen,
                                device=device)]
        q = rows[at] + mix["query_noise"] * torch.randn(
            (b - a) * nq, dim, generator=gen, device=device)
        pool[a:b] = torch.nn.functional.normalize(q, dim=1).view(
            b - a, nq, dim).cpu().numpy()
    n_ins = mix["clients"] * mix["inserts_per_client"] * mix["rows_per_insert"]
    at = live[torch.randint(len(live), (n_ins,), generator=gen,
                            device=device)]
    ins = torch.nn.functional.normalize(
        rows[at] + cell.cfg["db"]["row_noise"] * torch.nn.functional.normalize(
            torch.randn(n_ins, dim, generator=gen, device=device), dim=1),
        dim=1)
    inserts = ins.view(mix["clients"], mix["inserts_per_client"],
                       mix["rows_per_insert"], dim).cpu().numpy()
    return pool, inserts


@dataclass
class Deployment:
    cell: Cell
    seed: int
    device: torch.device
    log: Log
    db: Any = None
    n_filler: int = 0
    build_seq: int = 0
    pool: Optional[np.ndarray] = None
    inserts: Optional[np.ndarray] = None
    timings: Dict[str, float] = field(default_factory=dict)


def build(cell: Cell, seed: int, device) -> Deployment:
    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB

    cfg = cell.cfg
    dev = torch.device(device)
    dep = Deployment(cell=cell, seed=seed, device=dev, log=Log())
    log = dep.log
    t = time.perf_counter()
    dbc = cfg["db"]
    keys = ("index_type", "quant", "dim", "capacity", "nlist", "nprobe",
            "bucket_cap", "kmeans_iters", "flat_capacity", "train_sample")
    db = TorchVectorDB(DBConfig(use_kernel="fused", **{
        k: dbc[k] for k in keys if k in dbc}), device=dev)
    log.wrap_db(db)
    dep.db = db
    rows = draw_rows(cfg, seed, dev)
    n = cfg["db_rows"]
    per_doc = dbc["rows_per_doc"]

    def insert_rows(lo: int, hi: int, step: int = 1 << 17) -> None:
        for a in range(lo, hi, step):
            b = min(a + step, hi)
            chunks = [Chunk(-1, FILLER_DOC0 + i // per_doc, "")
                      for i in range(a, b)]
            log.rows_of_next_insert = (a, b)
            db.insert(rows[a:b], chunks)

    insert_rows(0, n)
    dep.n_filler = n
    dep.timings["rows_s"] = time.perf_counter() - t

    t = time.perf_counter()
    dep.build_seq = log.tick()
    db.build_index()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    insert_rows(n, n + dbc["fresh_rows"])
    for d in removed_docs(cfg, seed):
        db.remove(int(d))
    dep.pool, dep.inserts = search_pools(cell, seed, rows, dev)
    del rows
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    dep.timings["index_s"] = time.perf_counter() - t
    return dep
