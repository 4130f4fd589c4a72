"""Warm-up and the measured window.

The benchmark owns the clients and the clock: the search mix's closed-loop
clients call the program's DB directly, each from a stream of its own
(``traffic.streams``). A client starts no request once the window has
closed; a request counts in the window when it finishes inside it, and the
one in flight at the close is waited for (its lists are still checked).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ragbench.check import compact
from ragbench.deploy import INSERT_DOC0, Deployment
from ragbench.traffic.streams import SearchStreams

DRAIN_S = 300.0


@dataclass
class Window:
    t0: float
    t1: float
    requests: List[Dict[str, Any]] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0

    def done_in_window(self, op: str) -> List[Dict[str, Any]]:
        return [r for r in self.requests if r["op"] == op and r["ok"]
                and r["end"] <= self.t1]


def warm(dep: Deployment) -> None:
    """Every shape the cell's traffic uses, once, before the window: the
    kernels are built (nvcc, once per checkout) and every path launched."""
    import torch
    from repro_torch.kernels import _build

    if dep.device.type == "cuda":
        _build.build_all()
    for i in range(3):
        dep.db.search(dep.pool[-1 - i], dep.cell.mix["k"])
    if dep.device.type == "cuda":
        torch.cuda.synchronize(dep.device)
    dep.log.searches.clear()


def search_window(dep: Deployment, seconds: float,
                  main_hook: Optional[Callable[["Window"], None]] = None
                  ) -> Window:
    """``main_hook(window)``, where given, runs on the calling thread while
    the clients run (the traced run's profiler)."""
    from repro_torch.core.interfaces import Chunk

    cell, mix = dep.cell, dep.cell.mix
    from ragbench.deploy import FILLER_DOC0, removed_docs

    db_cfg = cell.cfg["db"]
    n_docs = (cell.cfg["db_rows"] + db_cfg["fresh_rows"]) // db_cfg[
        "rows_per_doc"]
    gone = set(removed_docs(cell.cfg, dep.seed).tolist())
    removable = np.array([d for d in range(FILLER_DOC0, FILLER_DOC0 + n_docs)
                          if d not in gone], dtype=np.int64)
    clients = mix["clients"]
    streams = SearchStreams(dep.seed, clients, mix["shares"],
                            len(dep.pool), removable,
                            mix["inserts_per_client"])
    k, per_ins = mix["k"], mix["rows_per_insert"]
    n_fresh_q = mix["fresh_queries_after_insert"]
    text = "inserted passage"
    win = Window(t0=0.0, t1=0.0)
    per_client: List[List[Dict[str, Any]]] = [[] for _ in range(clients)]
    errors: List[BaseException] = []
    start = threading.Barrier(clients + 1)

    def client(c: int) -> None:
        recs = per_client[c]
        fresh = None
        rng = streams.rng[c]
        try:
            start.wait()
            while time.perf_counter() < win.t1:
                r = streams.next(c)
                rec = {"op": r["op"], "n": 0, "ok": True}
                if r["op"] == "search":
                    q = dep.pool[r["pool"]]
                    if fresh is not None:
                        q = q.copy()
                        noisy = fresh + mix["query_noise"] * \
                            rng.standard_normal(fresh.shape)
                        q[:len(fresh)] = noisy / np.linalg.norm(
                            noisy, axis=1, keepdims=True)
                        rec["fresh"] = fresh_slots
                        fresh = None
                    rec["start"] = time.perf_counter()
                    dep.db.search(q, k)
                    rec["end"] = time.perf_counter()
                    rec["n"] = len(q)
                    rec["search"] = dep.log.last_search()
                    compact(rec["search"])
                elif r["op"] == "insert":
                    rows = dep.inserts[c, r["j"]]
                    doc = INSERT_DOC0 + c * mix["inserts_per_client"] + r["j"]
                    chunks = [Chunk(-1, doc, text) for _ in range(per_ins)]
                    rec["start"] = time.perf_counter()
                    dep.db.insert(rows, chunks)
                    rec["end"] = time.perf_counter()
                    fresh = rows[:n_fresh_q]
                    fresh_slots = [ch.chunk_id for ch in chunks[:n_fresh_q]]
                else:
                    rec["start"] = time.perf_counter()
                    dep.db.remove(r["doc"])
                    rec["end"] = time.perf_counter()
                recs.append(rec)
        except BaseException as e:                   # noqa: BLE001
            errors.append(e)
            recs.append({"op": "error", "n": 0, "ok": False,
                         "start": time.perf_counter(),
                         "end": float("inf")})

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"ragbench-client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    win.t0 = time.perf_counter()
    win.t1 = win.t0 + seconds
    start.wait()
    if main_hook is not None:
        main_hook(win)
    for t in threads:
        t.join(timeout=seconds + DRAIN_S)
    if errors:
        raise errors[0]
    for recs in per_client:
        for rec in recs:
            win.attempted += 1
            win.failed += not rec["ok"]
            win.requests.append(rec)
    return win
