"""What crosses the program's boundaries, recorded by the benchmark.

``Log`` wraps the DB's methods (on the instance, so nothing of the program
changes) and keeps, in order, what went in and came out: its inserts,
removals and searches, each with the sequence numbers of its entry and
exit, so a search can be set against the writes that ran beside it. The
correctness check judges these records after the window.

``Spans`` is the traced run's host spans (``time.time_ns``, the
profiler's clock, and the OS thread id, its thread ids), recorded only
while ``on``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np


class Spans:
    def __init__(self):
        self.on = False
        self.items: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, threading.get_native_id(), t0,
                               time.time_ns(), meta))


class Log:
    def __init__(self):
        self._lock = threading.Lock()
        self.seq = 0
        self.inserts: List[Dict[str, Any]] = []
        self.removes: List[Dict[str, Any]] = []
        self.searches: List[Dict[str, Any]] = []
        self.rows_of_next_insert: Optional[tuple] = None
        self._local = threading.local()
        self.spans = Spans()

    def tick(self) -> int:
        with self._lock:
            self.seq += 1
            return self.seq

    # -- the DB -------------------------------------------------------------

    def wrap_db(self, db) -> None:
        insert, remove, search = db.insert, db.remove, db.search

        def w_insert(vectors, chunks):
            rows, self.rows_of_next_insert = self.rows_of_next_insert, None
            a = self.tick()
            insert(vectors, chunks)
            b = self.tick()
            vec = None
            if rows is None:
                vec = np.array(vectors.detach().cpu() if hasattr(
                    vectors, "detach") else vectors, dtype=np.float32)
            self.inserts.append({
                "a": a, "b": b, "slots": np.array([c.chunk_id for c in chunks],
                                                  dtype=np.int64),
                "docs": np.array([c.doc_id for c in chunks], dtype=np.int64),
                "rows": rows, "vec": vec})

        def w_remove(doc_id):
            a = self.tick()
            n = remove(doc_id)
            self.removes.append({"a": a, "b": self.tick(), "doc": int(doc_id)})
            return n

        def w_search(vectors, k):
            a = self.tick()
            with self.spans.span("db.search"):
                t0 = time.perf_counter()
                res = search(vectors, k)
                t1 = time.perf_counter()
            rec = {"a": a, "b": self.tick(), "q": vectors, "res": res,
                   "k": k, "t0": t0, "t1": t1}
            self.searches.append(rec)
            self._local.last_search = rec
            return res

        db.insert, db.remove, db.search = w_insert, w_remove, w_search

    def last_search(self) -> Dict[str, Any]:
        """The record of this thread's last search."""
        return self._local.last_search
