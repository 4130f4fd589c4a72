"""Per-stage pipelined executor: stages as workers connected by bounded
queues.

The lock-step ``RAGPipeline.query`` puts a hard barrier after every stage —
while the LLM generates, the embedder and vector DB sit idle.  The
``StagedExecutor`` runs the *same* ``Stage`` objects as one worker thread per
stage connected by bounded queues, so stage N processes batch *i+1* while
stage N+1 processes batch *i* (software pipelining at the stage graph level;
RAGO, arXiv 2503.14649).  Each stage coalesces its own micro-batches from the
inbound queue up to its per-stage ``batch_size`` — the knob the paper's
stage-level scheduling argument is about.

Accounting: per-stage busy / input-starved (idle) / output-blocked (stall)
wall time, batch counts and occupancy, surfaced both as a report and as
``gauges()`` for ``ResourceMonitor``; per-request stage latency shares land
in ``StageTrace.latency_s`` exactly as on the lock-step path.

Stage workers never touch shared mutable state concurrently: each stage name
is timed by a single thread, so the shared ``StageTimer`` stays correct.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.interfaces import Chunk, SearchResult, StageTrace
from repro_torch.core.pipeline import RAGPipeline
from repro_torch.core.stages import QueryBatch, Stage, traces_from_batch

_SENTINEL = object()


@dataclass
class _Item:
    """One request in flight through the stage pipeline."""

    idx: int
    question: str
    ground_truth: str = ""
    gold: List[int] = field(default_factory=list)
    qvec: Optional[np.ndarray] = None
    result: Optional[SearchResult] = None
    candidates: Optional[List[Chunk]] = None
    context: Optional[List[Chunk]] = None
    reranked: Optional[List[int]] = None
    answer: Optional[str] = None
    latency_s: Dict[str, float] = field(default_factory=dict)
    # tracing: when this item last entered a stage queue, on the tracer's
    # clock (0.0 = untracked); each stage's per-item queue-wait span runs
    # from here to its batch's service start
    t_enq: float = 0.0


@dataclass
class StageStats:
    """Occupancy accounting for one stage worker (or replica pool).

    ``row()`` is the one schema the occupancy report, the serve-CLI JSON
    output, dashboards, and the autoscaler all share: ``batches`` and
    ``queue_depth_max`` ride along with the busy/idle/stall split so a
    controller can reason about backlog without a second bookkeeping path.
    """

    name: str
    busy_s: float = 0.0     # inside Stage.run
    idle_s: float = 0.0     # input-starved (waiting on the inbound queue)
    stall_s: float = 0.0    # output-blocked (downstream queue full)
    n_batches: int = 0
    n_items: int = 0
    queue_depth_max: int = 0   # deepest inbound queue seen at a pull
    replicas: int = 1          # workers serving this stage (elastic pools)
    n_failures: int = 0        # items terminally failed at this stage

    @property
    def occupancy(self) -> float:
        total = self.busy_s + self.idle_s + self.stall_s
        return self.busy_s / total if total > 0 else 0.0

    def observe_depth(self, depth: int) -> None:
        if depth > self.queue_depth_max:
            self.queue_depth_max = depth

    def row(self) -> Dict[str, float]:
        return {
            "stage": self.name, "busy_s": self.busy_s, "idle_s": self.idle_s,
            "stall_s": self.stall_s, "occupancy": self.occupancy,
            "batches": float(self.n_batches),
            "n_batches": float(self.n_batches), "n_items": float(self.n_items),
            "queue_depth_max": float(self.queue_depth_max),
            "replicas": float(self.replicas),
            "failures": float(self.n_failures),
            "mean_batch": self.n_items / self.n_batches if self.n_batches
            else 0.0,
        }


@dataclass
class StagedResult:
    traces: List[StageTrace]
    wall_s: float
    throughput_qps: float
    stage_stats: List[StageStats]

    def report(self) -> List[Dict[str, float]]:
        return [s.row() for s in self.stage_stats]


def _batch_from_items(items: List[_Item]) -> QueryBatch:
    """Assemble a batch envelope carrying each field's latest stage output
    (qvecs are only stacked while retrieval still needs them)."""
    qb = QueryBatch(questions=[i.question for i in items],
                    ground_truth=[i.ground_truth for i in items],
                    gold_chunks=[list(i.gold) for i in items])
    if all(i.result is not None for i in items):
        qb.results = [i.result for i in items]
        qb.candidates = [i.candidates for i in items]
    elif all(i.qvec is not None for i in items):
        qb.qvecs = np.stack([i.qvec for i in items])
    if all(i.context is not None for i in items):
        qb.contexts = [i.context for i in items]
        qb.reranked_ids = [i.reranked for i in items]
    if all(i.answer is not None for i in items):
        qb.answers = [i.answer for i in items]
    return qb


def _scatter_to_items(qb: QueryBatch, items: List[_Item]) -> None:
    """Copy newly-produced batch fields back onto the items."""
    for j, it in enumerate(items):
        if qb.qvecs is not None and it.qvec is None:
            it.qvec = np.asarray(qb.qvecs[j])
        if qb.results is not None and it.result is None:
            it.result = qb.results[j]
            it.candidates = qb.candidates[j]
        if qb.contexts is not None and it.context is None:
            it.context = qb.contexts[j]
            it.reranked = qb.reranked_ids[j]
        if qb.answers is not None and it.answer is None:
            it.answer = qb.answers[j]
        for k, v in qb.latency_s.items():
            it.latency_s[k] = it.latency_s.get(k, 0.0) + v


class StagedExecutor:
    """Run a pipeline's stage graph as pipelined workers.

    ``batch_sizes`` overrides per-stage micro-batches by stage name; a stage
    falls back to its spec-declared ``batch_size``, then ``default_batch``.
    ``queue_capacity`` bounds every inter-stage queue (backpressure instead
    of unbounded buffering).
    """

    def __init__(self, pipeline: RAGPipeline,
                 batch_sizes: Optional[Dict[str, int]] = None,
                 default_batch: int = 8, queue_capacity: int = 64,
                 coalesce_wait_s: float = 0.005, tracer=None):
        assert default_batch >= 1 and queue_capacity >= 1
        self.pipeline = pipeline
        self.coalesce_wait_s = coalesce_wait_s
        self.tracer = tracer              # optional obs.Tracer
        self.stages: List[Stage] = list(pipeline.stages)
        over = batch_sizes or {}
        self.batch_sizes = {
            s.name: int(over.get(s.name, 0) or s.batch_size or default_batch)
            for s in self.stages}
        self.queues: List[queue.Queue] = [
            queue.Queue(maxsize=queue_capacity)
            for _ in range(len(self.stages) + 1)]
        self.stats = [StageStats(name=s.name) for s in self.stages]
        # failure path: a raising stage sets _abort; every blocking queue op
        # polls it so the whole pipeline unwinds instead of deadlocking
        self._abort = threading.Event()
        self._error: Optional[BaseException] = None

    # -- monitor integration ------------------------------------------------

    def gauges(self) -> Dict[str, Callable[[], float]]:
        """Inter-stage queue depths for ``ResourceMonitor.add_gauges``."""
        out: Dict[str, Callable[[], float]] = {}
        for stage, q in zip(self.stages, self.queues):
            out[f"stage_{stage.name}_queue_depth"] = \
                (lambda q=q: float(q.qsize()))
        return out

    # -- worker loop --------------------------------------------------------

    def _get_abortable(self, q: queue.Queue):
        """Blocking get that unblocks (as end-of-stream) on abort."""
        while True:
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                if self._abort.is_set():
                    return _SENTINEL

    def _put_abortable(self, q: queue.Queue, obj) -> None:
        """Blocking put that gives up on abort (the run is failing)."""
        while True:
            try:
                return q.put(obj, timeout=0.05)
            except queue.Full:
                if self._abort.is_set():
                    return

    def _fail(self, err: BaseException) -> None:
        if self._error is None:
            self._error = err
        self._abort.set()

    def _run_batch(self, stage: Stage, stats: StageStats,
                   items: List[_Item], out_q: queue.Queue) -> None:
        qb = _batch_from_items(items)
        tr = self.tracer
        if tr is not None:
            t_svc = tr.now()
            for it in items:
                if it.t_enq > 0.0:
                    tr.add_span(f"{stage.name}.queue", it.t_enq, t_svc,
                                cat="queue", tid=stage.name, req=it.idx)
        t0 = time.perf_counter()
        qb = stage.run(qb)
        dt = time.perf_counter() - t0
        stats.busy_s += dt
        stats.n_batches += 1
        stats.n_items += len(items)
        _scatter_to_items(qb, items)
        if tr is not None:
            te = tr.now()
            for it in items:
                tr.add_span(stage.name, te - dt, te, cat="service",
                            tid=stage.name, req=it.idx, n=len(items))
                it.t_enq = te
        t1 = time.perf_counter()
        # batch-granular handoff downstream
        self._put_abortable(out_q, items)
        stats.stall_s += time.perf_counter() - t1

    def _worker(self, si: int) -> None:
        """Coalesce micro-batches from the inbound queue up to this stage's
        batch size and run them; queue elements are item *lists* (one queue
        op per upstream batch, not per request) and a local pending buffer
        re-batches across differently-sized upstream batches in order."""
        stage, stats = self.stages[si], self.stats[si]
        bs = self.batch_sizes[stage.name]
        in_q, out_q = self.queues[si], self.queues[si + 1]
        pending: deque = deque()
        closed = False

        def pull(timeout: Optional[float]) -> bool:
            """Move one inbound batch into pending; False on timeout/close."""
            nonlocal closed
            stats.observe_depth(in_q.qsize())
            t_wait = time.perf_counter()
            try:
                if timeout is None:
                    chunk = self._get_abortable(in_q)
                elif timeout > 0:
                    chunk = in_q.get(timeout=timeout)
                else:
                    chunk = in_q.get_nowait()
            except queue.Empty:
                return False
            finally:
                stats.idle_s += time.perf_counter() - t_wait
            if chunk is _SENTINEL:
                closed = True
                return False
            pending.extend(chunk)
            return True

        try:
            while True:
                if not pending:
                    if closed:
                        self._put_abortable(out_q, _SENTINEL)
                        return
                    pull(None)                   # block for work
                    continue
                # deadline-triggered coalescing (continuous batching at the
                # stage level): wait up to coalesce_wait_s for a full batch
                # so a fast upstream doesn't degrade us into singleton
                # batches, but flush immediately at end of stream
                deadline = time.perf_counter() + self.coalesce_wait_s
                while len(pending) < bs and not closed:
                    if not pull(deadline - time.perf_counter()):
                        break
                items = [pending.popleft()
                         for _ in range(min(bs, len(pending)))]
                self._run_batch(stage, stats, items, out_q)
        except BaseException as e:               # noqa: BLE001
            self._fail(e)

    # -- drive --------------------------------------------------------------

    def run(self, questions: Sequence[str],
            ground_truth: Optional[Sequence[str]] = None,
            gold_chunks: Optional[Sequence[List[int]]] = None) -> StagedResult:
        n = len(questions)
        t_enq = self.tracer.now() if self.tracer is not None else 0.0
        items = [
            _Item(idx=i, question=q,
                  ground_truth=ground_truth[i] if ground_truth else "",
                  gold=list(gold_chunks[i]) if gold_chunks else [],
                  t_enq=t_enq)
            for i, q in enumerate(questions)]
        workers = [threading.Thread(target=self._worker, args=(i,),
                                    name=f"ragperf-stage-{s.name}")
                   for i, s in enumerate(self.stages)]
        done: List[_Item] = []

        def collect() -> None:
            while True:
                out = self._get_abortable(self.queues[-1])
                if out is _SENTINEL:
                    return
                done.extend(out)

        collector = threading.Thread(target=collect, name="ragperf-stage-sink")
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        collector.start()
        feed = self.batch_sizes[self.stages[0].name] if self.stages else 8
        for lo in range(0, n, feed):          # bounded: blocks = backpressure
            if self._abort.is_set():
                break
            self._put_abortable(self.queues[0], items[lo:lo + feed])
        self._put_abortable(self.queues[0], _SENTINEL)
        for w in workers:
            w.join()
        collector.join()
        wall = time.perf_counter() - t0
        if self._error is not None:
            raise self._error
        assert len(done) == n, f"lost items: {len(done)} != {n}"
        done.sort(key=lambda it: it.idx)
        # reassemble one batch envelope so trace construction stays owned by
        # stages.traces_from_batch (per-item latency overrides the shared
        # batch dict)
        traces = traces_from_batch(
            _batch_from_items(done),
            latency_s=[dict(it.latency_s) for it in done])
        self.pipeline.traces.extend(traces)
        return StagedResult(traces=traces, wall_s=wall,
                            throughput_qps=n / wall if wall > 0 else 0.0,
                            stage_stats=list(self.stats))
