"""Continuous query batching over a mixed read/write request queue.

Arrivals land in a thread-safe queue; a single executor thread pulls
*dynamic* batches: queries coalesce until either the batch is full
(``max_batch``) or the oldest queued query has waited ``max_wait_s``
(deadline trigger), so the effective batch size adapts to load — near-empty
queues give latency-optimal singleton batches, saturated queues give
throughput-optimal full batches (continuous batching, Shen et al.
arXiv:2412.11854 §4).

Index mutations (insert/update/removal) ride the same queue and execute as
singleton "batches", so they contend with reads exactly as in a live
deployment.  ``BatchPolicy.priority`` picks the contention model:

* ``fifo``           — strict head-of-line by enqueue time (a mutation at the
                       head acts as a batch barrier);
* ``query_first``    — reads bypass pending writes (writes drain at idle);
* ``mutation_first`` — writes preempt reads (freshness-critical stores).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from repro_torch.serving.accounting import RequestRecord
from repro_torch.workload.generator import Request

MUTATION_OPS = ("insert", "update", "removal")


@dataclass
class BatchPolicy:
    max_batch: int = 8
    max_wait_s: float = 0.02
    priority: str = "fifo"        # fifo | query_first | mutation_first

    def __post_init__(self):
        assert self.max_batch >= 1
        assert self.priority in ("fifo", "query_first", "mutation_first"), \
            self.priority


@dataclass
class Submission:
    """A request in flight: workload payload + accounting + completion signal."""
    request: Request
    record: RequestRecord
    enqueue_t: float = 0.0        # perf_counter at submit()
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    finished: bool = False        # set once by the first _finish (idempotence)


class ContinuousBatcher:
    def __init__(self, policy: BatchPolicy = BatchPolicy()):
        self.policy = policy
        self._queries: Deque[Submission] = deque()
        self._mutations: Deque[Submission] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.peak_depth = 0

    # -- producer side -----------------------------------------------------

    def submit(self, sub: Submission) -> None:
        with self._cv:
            assert not self._closed, "submit() after close()"
            sub.enqueue_t = time.perf_counter()
            if sub.request.op == "query":
                self._queries.append(sub)
            else:
                self._mutations.append(sub)
            self.peak_depth = max(self.peak_depth, self._depth_locked())
            self._cv.notify_all()

    def close(self) -> None:
        """No more arrivals; get_batch() drains the queue then returns None."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- consumer side -----------------------------------------------------

    def _depth_locked(self) -> int:
        return len(self._queries) + len(self._mutations)

    def depth(self) -> int:
        with self._cv:
            return self._depth_locked()

    def _mutation_goes_first(self) -> bool:
        if not self._mutations:
            return False
        if not self._queries:
            return True
        pr = self.policy.priority
        if pr == "mutation_first":
            return True
        if pr == "query_first":
            return False
        return self._mutations[0].enqueue_t <= self._queries[0].enqueue_t

    def _pop_ready_locked(self, now: float) -> Optional[List[Submission]]:
        if self._mutation_goes_first():
            return [self._mutations.popleft()]
        if not self._queries:
            return None
        # under fifo a pending mutation is a barrier: the batch may only
        # take queries that arrived before it
        barrier_t = (self._mutations[0].enqueue_t
                     if self.policy.priority == "fifo" and self._mutations
                     else None)
        eligible = len(self._queries)
        if barrier_t is not None:
            eligible = sum(1 for s in self._queries
                           if s.enqueue_t <= barrier_t)
        full = eligible >= self.policy.max_batch
        expired = now - self._queries[0].enqueue_t >= self.policy.max_wait_s
        if full or expired or self._closed:
            n = min(eligible, self.policy.max_batch)
            return [self._queries.popleft() for _ in range(n)]
        return None

    def get_batch(self) -> Optional[List[Submission]]:
        """Block until a batch is ready; None once closed and drained."""
        with self._cv:
            while True:
                batch = self._pop_ready_locked(time.perf_counter())
                if batch is not None:
                    return batch
                if self._closed and not self._depth_locked():
                    return None
                if self._queries:
                    # sleep at most until the oldest query's deadline expires
                    deadline = (self._queries[0].enqueue_t
                                + self.policy.max_wait_s)
                    timeout = max(deadline - time.perf_counter(), 0.0)
                    self._cv.wait(timeout=min(timeout, 0.05) + 1e-4)
                else:
                    self._cv.wait(timeout=0.05)
