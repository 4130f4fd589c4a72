"""Elastic replicated stage execution: per-stage replica pools + one writer.

``StagedExecutor`` runs one worker per stage; under bursty arrivals a
single slow stage becomes the whole pipeline's service rate and the tail
explodes.  ``ElasticExecutor`` generalizes it to **N replica workers per
stage** pulling from shared bounded queues (data-parallel pipeline copies at
stage granularity — the per-stage parallelism allocation RAGO,
arXiv 2503.14649, argues dominates RAG serving), with three runtime control
surfaces an ``AutoscaleController`` can drive:

* ``set_replicas(stage, n)``   — grow/shrink a stage's worker pool;
* ``set_batch_size(stage, b)`` — retune a stage's coalescing micro-batch;
* ``apply_knobs(nprobe=, rerank_k=)`` — walk the retrieval quality ladder
  (RAG-Stack, arXiv 2510.20296: ``nprobe``/``rerank_k`` trade quality for
  latency along a measurable Pareto front).

Index mutations never touch the replica pools: ``submit_mutation`` routes
them to a **single serialized writer thread** that coalesces pending ops and
applies them batched (one chunking pass, one embedder call, per-doc
insert/update under the DB's mutation lock), so replicas race on queues,
never on ``DBInstance`` index state.

Queues are item-granular: any replica of stage *k* may pull any request, so
completion order is load-dependent; ``run()`` restores submission order and
produces outputs identical to the lock-step path (scheduling freedom, never
semantics).  Service mode (``submit``/``submit_mutation`` + ``drain``) backs
``ServingHarness`` open/closed-loop serving.

Failure model (the chaos contract): a worker exception fails *that batch's
items*, not the run — each item is requeued up to ``max_retries`` times,
then marked failed and surfaced through ``on_done`` with its error, so every
submitted request reaches a terminal state (completed or explicitly failed).
Replicas carry stable per-pool ids and a chaos surface (``kill_replica`` /
``set_replica_slow`` / ``stall_writer`` / ``spawn_replica``); per-replica
service times feed a ``StragglerDetector`` so a controller can
``retire_replica`` a flagged slowpoke and re-grow the pool.  Run-wide abort
is reserved for errors outside stage execution (bookkeeping bugs, failing
``on_done`` callbacks).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.interfaces import Chunk
from repro_torch.core.pipeline import RAGPipeline
from repro_torch.core.stages import (GenerateStage, RerankStage,
                                     RetrieveStage, traces_from_batch)
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.serving.accounting import percentile
from repro_torch.serving.staged import (StagedResult, StageStats,
                                        _batch_from_items, _Item,
                                        _scatter_to_items)
from repro_torch.workload.generator import Request

_POLL_S = 0.02     # starved-worker poll; also bounds end-of-stream latency


class ReplicaKilled(Exception):
    """A replica died (injected or retired) while holding a batch."""


@dataclass
class _ElasticItem(_Item):
    """A request in flight through the replica pools, plus service timing
    and an optional completion callback (service mode)."""

    t_submit: float = 0.0
    t_start: float = 0.0
    on_done: Optional[Callable[["_ElasticItem"], None]] = None
    retries: int = 0
    error: Optional[BaseException] = None

    @property
    def failed(self) -> bool:
        return self.error is not None


@dataclass
class _ReplicaCtl:
    """Per-replica control block (chaos surface + liveness)."""

    rid: int
    kill: bool = False       # die at the next loop check (requeue any batch)
    slow: float = 1.0        # service-time multiplier (straggler injection)


@dataclass
class ElasticResult(StagedResult):
    """StagedResult + the elastic run's write/failure-path accounting."""

    write_batches: List[int] = field(default_factory=list)
    n_failed: int = 0
    n_retried: int = 0
    mutations_applied: int = 0
    mutations_failed: int = 0

    @property
    def mean_write_batch(self) -> float:
        return (sum(self.write_batches) / len(self.write_batches)
                if self.write_batches else 0.0)


class ElasticExecutor:
    """Run a pipeline's stage graph as elastic replica pools.

    ``replicas`` maps stage names to initial pool widths (default 1);
    ``max_replicas`` caps runtime growth.  ``batch_sizes`` follows the
    ``StagedExecutor`` convention (explicit override > spec-declared
    ``batch_size`` > ``default_batch``) but is mutable at runtime.

    The executor is single-shot: ``start()`` → submissions → ``drain()``
    (or the all-in-one ``run()``).
    """

    def __init__(self, pipeline: RAGPipeline,
                 replicas: Optional[Dict[str, int]] = None,
                 batch_sizes: Optional[Dict[str, int]] = None,
                 default_batch: int = 8, max_replicas: int = 4,
                 queue_capacity: int = 512, coalesce_wait_s: float = 0.005,
                 mutation_batch: int = 8, max_retries: int = 2,
                 straggler_tolerance: float = 0.0,
                 straggler_window: int = 16, tracer=None):
        assert default_batch >= 1 and queue_capacity >= 1
        assert max_replicas >= 1 and mutation_batch >= 1
        assert max_retries >= 0
        self.pipeline = pipeline
        self.tracer = tracer              # optional obs.Tracer
        self.stages = list(pipeline.stages)
        self.max_replicas = max_replicas
        self.coalesce_wait_s = coalesce_wait_s
        self.mutation_batch = mutation_batch
        over = batch_sizes or {}
        self.batch_sizes: Dict[str, int] = {  # guarded-by: _lock
            s.name: int(over.get(s.name, 0) or s.batch_size or default_batch)
            for s in self.stages}
        self.base_batch_sizes = dict(self.batch_sizes)
        rep = replicas or {}
        self._stage_idx = {s.name: i for i, s in enumerate(self.stages)}
        self._target = [max(1, min(int(rep.get(s.name, 1)), max_replicas))
                        for s in self.stages]   # guarded-by: _lock
        # per-replica stage instances: each worker checks one out of the
        # pool; stages over shared thread-safe components hand back ``self``
        # from replica_copy, while the generation stage clones a ModelLLM
        # view per worker (the same weight tensors + thread-safe GenStats)
        self._stage_pool: List[List] = [[s] for s in self.stages]  # guarded-by: _lock
        self._stage_instances: List[List] = [[s] for s in self.stages]  # guarded-by: _lock
        self.stats = [StageStats(name=s.name, replicas=self._target[i])
                      for i, s in enumerate(self.stages)]
        self.queues: List[queue.Queue] = [
            queue.Queue(maxsize=queue_capacity)
            for _ in range(len(self.stages) + 1)]
        # _closed[i]: no further put to queues[i] will ever happen
        self._closed = [threading.Event()
                        for _ in range(len(self.stages) + 1)]
        self._active = [0] * len(self.stages)   # guarded-by: _lock
        self._shrink = [0] * len(self.stages)   # guarded-by: _lock
        self._lock = threading.Lock()
        self._abort = threading.Event()
        self._error: Optional[BaseException] = None   # guarded-by: _lock
        self._threads: List[threading.Thread] = []    # guarded-by: _lock
        self._started = False
        # failure isolation / chaos surface
        self.max_retries = max_retries
        self._ctl: List[Dict[int, _ReplicaCtl]] = [  # guarded-by: _lock
            {} for _ in self.stages]          # alive replicas by rid
        self._next_rid = [0] * len(self.stages)   # guarded-by: _lock
        self.n_failed = 0    # guarded-by: _lock
        self.n_retried = 0   # guarded-by: _lock
        # per-replica service-time tracking (straggler detection); tolerance
        # 0 disables flagging but per-replica recording stays cheap and on
        self.straggler_tolerance = straggler_tolerance
        self._straggler = [StragglerDetector(window=straggler_window,
                                             tolerance=straggler_tolerance
                                             or 2.0,
                                             min_samples=2)
                           for _ in self.stages]
        # write path
        self._wq: "queue.Queue[Tuple[Request, Optional[Callable]]]" = \
            queue.Queue(maxsize=queue_capacity)
        self._writer_closed = threading.Event()
        self._writer_resume_t: Optional[float] = None   # guarded-by: _lock
        self.write_batches: List[int] = []   # guarded-by: _lock
        self.mutations_applied = 0           # guarded-by: _lock
        self.mutations_failed = 0            # guarded-by: _lock
        # completion tracking
        self._done: List[_ElasticItem] = []  # guarded-by: _lock
        self._next_idx = 0                   # guarded-by: _lock
        self._recent_ms: List[float] = []    # guarded-by: _lock
        self._recent_cap = 512
        self.n_completed = 0                 # guarded-by: _lock
        # knob state (current values surfaced as gauges / snapshot)
        self.knobs: Dict[str, int] = self._read_knobs()   # guarded-by: _lock

    # -- knob plumbing ------------------------------------------------------

    def _read_knobs(self) -> Dict[str, int]:
        nprobe, rerank_k, max_new = 0, 0, 0
        for st in self.stages:
            if isinstance(st, RetrieveStage):
                cfg = getattr(st.db, "cfg", None)
                nprobe = int(getattr(cfg, "nprobe", 0) or 0)
            if isinstance(st, RerankStage):
                rerank_k = int(st.rerank_k)
            if isinstance(st, GenerateStage):
                max_new = int(getattr(st.llm, "max_new", 0) or 0)
        return {"nprobe": nprobe, "rerank_k": rerank_k, "max_new": max_new}

    def apply_knobs(self, nprobe: Optional[int] = None,
                    rerank_k: Optional[int] = None,
                    max_new: Optional[int] = None) -> None:
        """Set quality knobs; takes effect on the next batch.  ``max_new``
        reaches every generation replica's generator (later batches decode
        shorter), joining ``nprobe``/``rerank_k`` on the quality ladder."""
        for st in self.stages:
            if nprobe is not None and isinstance(st, RetrieveStage) \
                    and hasattr(st.db, "set_nprobe"):
                # knob applied to the component outside the executor lock
                # (set_nprobe takes the DB's own lock; nesting would impose
                # a _lock -> _mu order the search path need not share)
                st.db.set_nprobe(nprobe)
                with self._lock:
                    self.knobs["nprobe"] = max(1, int(nprobe))
            if rerank_k is not None and isinstance(st, RerankStage):
                st.rerank_k = max(1, int(rerank_k))
                with self._lock:
                    self.knobs["rerank_k"] = max(1, int(rerank_k))
        if max_new is not None:
            si = self._stage_idx.get(GenerateStage.name)
            if si is not None:
                with self._lock:
                    instances = list(self._stage_instances[si])
                applied = 0
                for st in instances:
                    if hasattr(st.llm, "set_max_new"):
                        applied = st.llm.set_max_new(max_new)
                if applied:
                    with self._lock:
                        self.knobs["max_new"] = applied

    # -- scaling surface ----------------------------------------------------

    def replicas_of(self, stage_name: str) -> int:
        with self._lock:
            return self._target[self._stage_idx[stage_name]]

    def set_replicas(self, stage_name: str, n: int) -> int:
        """Grow/shrink a stage's pool; returns the clamped applied target."""
        si = self._stage_idx[stage_name]
        n = max(1, min(int(n), self.max_replicas))
        with self._lock:
            grow = n - self._target[si]
        if grow > 0:
            # build the new workers' stage instances (for generation: the
            # replica's ModelLLM view) before they enter the data path
            self._warm_pool(si, grow)
        with self._lock:
            cur = self._target[si]
            if n > cur:
                for _ in range(n - cur):
                    self._spawn_worker_locked(si)
            elif n < cur:
                self._shrink[si] += cur - n
            self._target[si] = n
            self.stats[si].replicas = n
        return n

    def set_batch_size(self, stage_name: str, bs: int) -> int:
        bs = max(1, int(bs))
        with self._lock:
            self.batch_sizes[stage_name] = bs
        return bs

    # -- chaos surface (fault injection + recovery) -------------------------

    def alive_replicas(self, stage_name: str) -> List[int]:
        """Sorted rids of the stage's live (not kill-flagged) replicas."""
        si = self._stage_idx[stage_name]
        with self._lock:
            return sorted(r for r, c in self._ctl[si].items() if not c.kill)

    def kill_replica(self, stage_name: str, index: int = 0,
                     rid: Optional[int] = None,
                     allow_last: bool = False) -> int:
        """Deterministically kill one alive replica of a stage pool.

        The victim dies at its next loop check; any batch it holds rides the
        requeue/fail path (``max_retries`` budget).  Refuses to take the last
        replica unless ``allow_last`` (a respawn is scheduled) — a permanently
        empty pool would strand its queue.  Returns the killed rid or -1.
        """
        si = self._stage_idx[stage_name]
        with self._lock:
            alive = sorted(r for r, c in self._ctl[si].items() if not c.kill)
            if not alive or (len(alive) <= 1 and not allow_last):
                return -1
            victim = rid if rid is not None and rid in self._ctl[si] \
                else alive[index % len(alive)]
            self._ctl[si][victim].kill = True
            self._target[si] = max(1, self._target[si] - 1)
            self.stats[si].replicas = self._target[si]
            self._straggler[si].forget(victim)
        return victim

    def spawn_replica(self, stage_name: str) -> int:
        """Spawn one fresh replica (chaos respawn / pool re-grow); returns
        its rid, or -1 when the pool is already at ``max_replicas``."""
        si = self._stage_idx[stage_name]
        with self._lock:
            if self._active[si] >= self.max_replicas:
                return -1
        self._warm_pool(si, 1)
        with self._lock:
            rid = self._spawn_worker_locked(si)
            self._target[si] = min(max(self._target[si], self._active[si]),
                                   self.max_replicas)
            self.stats[si].replicas = self._target[si]
        return rid

    def set_replica_slow(self, stage_name: str, factor: float,
                         index: int = 0, rid: Optional[int] = None) -> int:
        """Turn one replica into a slow straggler (service time × factor;
        1.0 restores health).  Returns the affected rid or -1."""
        si = self._stage_idx[stage_name]
        with self._lock:
            alive = sorted(r for r, c in self._ctl[si].items() if not c.kill)
            if not alive:
                return -1
            victim = rid if rid is not None and rid in self._ctl[si] \
                else alive[index % len(alive)]
            self._ctl[si][victim].slow = max(1.0, float(factor))
        return victim

    def stall_writer(self, duration_s: float) -> None:
        """Freeze the serialized mutation writer for ``duration_s`` —
        pending mutations back up, then drain on resume."""
        with self._lock:
            self._writer_resume_t = \
                time.perf_counter() + max(0.0, duration_s)

    def retire_replica(self, stage_name: str, rid: int) -> int:
        """Controller-driven recovery: kill a flagged replica and spawn a
        fresh one in its slot (net pool width unchanged).  Returns the
        replacement's rid, or -1 when ``rid`` is already gone."""
        si = self._stage_idx[stage_name]
        with self._lock:
            ctl = self._ctl[si].get(rid)
            if ctl is None or ctl.kill:     # already gone (or going)
                return -1
            ctl.kill = True
            self._straggler[si].forget(rid)
        self._warm_pool(si, 1)
        with self._lock:
            return self._spawn_worker_locked(si)

    def straggler_rids(self) -> List[Tuple[str, int]]:
        """(stage, rid) pairs whose per-item service time is flagged by the
        per-stage ``StragglerDetector``; empty when detection is disabled
        (``straggler_tolerance == 0``)."""
        if not self.straggler_tolerance:
            return []
        out: List[Tuple[str, int]] = []
        with self._lock:
            for si, stage in enumerate(self.stages):
                for rid in self._straggler[si].stragglers():
                    out.append((stage.name, int(rid)))
        return out

    # -- monitor integration ------------------------------------------------

    def gauges(self) -> Dict[str, Callable[[], float]]:
        """Queue depths, replica counts and knob values for the monitor."""
        out: Dict[str, Callable[[], float]] = {}
        for si, stage in enumerate(self.stages):
            q = self.queues[si]
            out[f"elastic_{stage.name}_queue_depth"] = \
                (lambda q=q: float(q.qsize()))
            out[f"elastic_{stage.name}_replicas"] = \
                (lambda si=si: float(self._target[si]))  # noqa: lock-discipline -- monitor-only sample; int read is GIL-atomic and a stale width is fine for a gauge
        out["elastic_write_queue_depth"] = lambda: float(self._wq.qsize())
        # monitor-only samples: single dict reads are GIL-atomic and a
        # one-interval-stale knob value cannot mislead the timeline
        out["elastic_nprobe"] = lambda: float(self.knobs["nprobe"])  # noqa: lock-discipline
        out["elastic_rerank_k"] = lambda: float(self.knobs["rerank_k"])  # noqa: lock-discipline
        out["elastic_max_new"] = lambda: float(self.knobs.get("max_new", 0))  # noqa: lock-discipline
        return out

    def snapshot(self) -> List[Dict[str, float]]:
        """Per-stage occupancy/backlog rows (cumulative counters; the
        controller windows them by differencing successive snapshots)."""
        rows = []
        with self._lock:
            for si, stage in enumerate(self.stages):
                rows.append({
                    **self.stats[si].row(),
                    "queue_depth": float(self.queues[si].qsize()),
                    "batch_size": float(self.batch_sizes[stage.name])})
        return rows

    def recent_p95_ms(self) -> float:
        with self._lock:
            xs = list(self._recent_ms)
        return percentile(xs, 95)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ElasticExecutor":
        if self._started:
            return self
        self._started = True
        # warm-pool init: build every initial replica's stage instance (for
        # generation: a ModelLLM view) *before* traffic, so scale-out at
        # admission time never pays construction cost on the data path
        with self._lock:
            widths = list(self._target)
        for si, width in enumerate(widths):
            self._warm_pool(si, width)
        with self._lock:
            for si in range(len(self.stages)):
                for _ in range(self._target[si]):
                    self._spawn_worker_locked(si)
            for target, name in ((self._collector, "ragperf-elastic-sink"),
                                 (self._writer_loop,
                                  "ragperf-elastic-writer")):
                t = threading.Thread(target=target, name=name)
                t.start()
                self._threads.append(t)
        return self

    def _spawn_worker_locked(self, si: int) -> int:  # locked-by: _lock
        rid = self._next_rid[si]
        self._next_rid[si] += 1
        self._ctl[si][rid] = _ReplicaCtl(rid=rid)
        self._active[si] += 1
        t = threading.Thread(
            target=self._worker, args=(si, rid),
            name=f"ragperf-elastic-{self.stages[si].name}-r{rid}")
        t.start()
        self._threads.append(t)
        return rid

    # -- per-replica stage instances ----------------------------------------

    def _warm_pool(self, si: int, n: int) -> None:
        """Grow stage ``si``'s instance pool to ``n`` available copies."""
        while True:
            with self._lock:
                if len(self._stage_pool[si]) >= n:
                    return
            inst = self.stages[si].replica_copy()
            with self._lock:
                self._stage_pool[si].append(inst)
                if inst is not self.stages[si]:
                    self._stage_instances[si].append(inst)

    def _checkout_stage(self, si: int):
        with self._lock:
            if self._stage_pool[si]:
                return self._stage_pool[si].pop()
        inst = self.stages[si].replica_copy()
        with self._lock:
            if inst is not self.stages[si]:
                self._stage_instances[si].append(inst)
        return inst

    def _return_stage(self, si: int, inst) -> None:
        with self._lock:
            self._stage_pool[si].append(inst)

    def close_intake(self) -> None:
        """No further submissions; pools drain then shut down in order."""
        self._closed[0].set()
        self._writer_closed.set()

    def drain(self) -> None:
        """Wait until every in-flight request has completed (or the run
        aborted), then re-raise the first run-level error if any."""
        self.close_intake()
        while True:
            self._propagate_closure()
            with self._lock:
                threads = list(self._threads)
            pending = [t for t in threads if t.is_alive()]
            for t in pending:
                t.join(timeout=_POLL_S)
            with self._lock:
                # a controller may have spawned workers mid-join; loop until
                # the thread set is stable and fully joined
                stable = len(self._threads) == len(threads)
            if stable and not any(t.is_alive() for t in threads):
                break
        with self._lock:
            err = self._error
        if err is not None:
            raise err

    def _propagate_closure(self) -> None:
        """Drain-time safety net: a closed stage whose pool emptied (chaos
        kill without respawn) will never serve its queue again — fail any
        stranded items and propagate closure so the run still terminates
        with every request in a terminal state."""
        with self._lock:
            active = list(self._active)
        for si, stage in enumerate(self.stages):
            if not self._closed[si].is_set() or active[si] > 0:
                continue
            while True:
                try:
                    it = self.queues[si].get_nowait()
                except queue.Empty:
                    break
                it.error = it.error or ReplicaKilled(
                    f"stage {stage.name} has no replicas left")
                self._put_abortable(self.queues[-1], it)
            self._closed[si + 1].set()

    def aborted(self) -> bool:
        return self._abort.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        """First run-level error (None while healthy)."""
        with self._lock:
            return self._error

    # -- submission ---------------------------------------------------------

    def submit(self, question: str, ground_truth: str = "",
               gold: Optional[List[int]] = None,
               on_done: Optional[Callable[[_ElasticItem], None]] = None
               ) -> _ElasticItem:
        """Enqueue one query into the stage graph (service mode)."""
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        item = _ElasticItem(idx=idx, question=question,
                            ground_truth=ground_truth,
                            gold=list(gold or []),
                            t_submit=time.perf_counter(), on_done=on_done)
        if self.tracer is not None:
            item.t_enq = self.tracer.now()
        if not self._put_abortable(self.queues[0], item):
            # aborted executor: never silently drop — the caller must still
            # see a terminal state for this request
            with self._lock:
                item.error = self._error or RuntimeError(
                    "ElasticExecutor aborted; request rejected")
                self.n_failed += 1
            if on_done is not None:
                on_done(item)
                return item
            raise RuntimeError(
                "submit() on an aborted executor") from item.error
        return item

    def submit_mutation(self, req: Request,
                        on_done: Optional[Callable[
                            [Optional[BaseException]], None]] = None) -> None:
        """Enqueue an index mutation onto the serialized writer path."""
        assert req.op in ("insert", "update", "removal"), req.op
        if not self._put_abortable(self._wq, (req, on_done)):
            with self._lock:
                err = self._error or RuntimeError(
                    "ElasticExecutor aborted; mutation rejected")
                self.mutations_failed += 1
            if on_done is not None:
                on_done(err)
                return
            raise RuntimeError(
                "submit_mutation() on an aborted executor") from err

    def trace_for(self, item: _ElasticItem):
        """Per-request §3.3.2 trace for a completed item (service mode)."""
        return traces_from_batch(_batch_from_items([item]),
                                 latency_s=[dict(item.latency_s)],
                                 n_attempts=[item.retries + 1])[0]

    # -- failure path -------------------------------------------------------

    def _fail(self, err: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = err
        self._abort.set()

    def _put_abortable(self, q: queue.Queue, obj) -> bool:
        """Blocking put that gives up on abort; False means *not enqueued*
        (the caller owns the object's terminal state).  The abort check
        comes first: an aborted executor's pools are dead, so enqueueing
        anything — even with queue room — would strand it forever."""
        while True:
            if self._abort.is_set():
                return False
            try:
                q.put(obj, timeout=_POLL_S)
                return True
            except queue.Full:
                pass

    def _requeue_or_fail(self, si: int, stats: StageStats,
                         items: List[_ElasticItem],
                         err: BaseException) -> None:
        """Worker-exception isolation: the failed batch's items retry
        (bounded ``max_retries`` budget) or fail terminally through the
        collector — never a run-wide abort."""
        tr = self.tracer
        for it in items:
            it.retries += 1
            if it.retries > self.max_retries:
                it.error = err
                with self._lock:
                    stats.n_failures += 1
                if tr is not None:
                    tr.instant("fail", tid=self.stages[si].name, req=it.idx,
                               cat="retry", attempts=it.retries,
                               error=type(err).__name__)
                self._put_abortable(self.queues[-1], it)
            else:
                with self._lock:
                    self.n_retried += 1
                if tr is not None:
                    it.t_enq = tr.now()
                    tr.instant("requeue", tid=self.stages[si].name,
                               req=it.idx, cat="retry", attempt=it.retries)
                self._put_abortable(self.queues[si], it)

    def _killed(self, si: int, rid: int) -> bool:
        with self._lock:
            ctl = self._ctl[si].get(rid)
            return ctl is None or ctl.kill

    def _slow_factor(self, si: int, rid: int) -> float:
        with self._lock:
            ctl = self._ctl[si].get(rid)
            return ctl.slow if ctl is not None else 1.0

    def _unregister(self, si: int, rid: int) -> None:
        with self._lock:
            self._ctl[si].pop(rid, None)

    # -- stage workers ------------------------------------------------------

    def _take_shrink(self, si: int) -> bool:
        with self._lock:
            if self._shrink[si] > 0 and self._active[si] > 1:
                self._shrink[si] -= 1
                self._active[si] -= 1
                return True
        return False

    def _retire(self, si: int) -> None:
        """Worker exit at end-of-stream/abort: the last one out propagates
        closure downstream (no more puts to queues[si+1] can happen)."""
        with self._lock:
            self._active[si] -= 1
            last = self._active[si] == 0
        if last and (self._closed[si].is_set() or self._abort.is_set()):
            self._closed[si + 1].set()

    def _worker(self, si: int, rid: int) -> None:
        # each worker runs its own stage instance (per-replica generators);
        # returned to the pool on any exit path for reuse
        stage, stats = self._checkout_stage(si), self.stats[si]
        in_q, out_q = self.queues[si], self.queues[si + 1]
        try:
            while not self._abort.is_set():
                if self._take_shrink(si):
                    self._return_stage(si, stage)
                    self._unregister(si, rid)
                    return            # retired by scale-down, not stream end
                if self._killed(si, rid):
                    break             # chaos kill/retire; _retire accounts
                with self._lock:
                    stats.observe_depth(in_q.qsize())
                t_wait = time.perf_counter()
                try:
                    first = in_q.get(timeout=_POLL_S)
                except queue.Empty:
                    with self._lock:
                        stats.idle_s += time.perf_counter() - t_wait
                    if self._closed[si].is_set() and in_q.empty():
                        break         # end of stream for this stage
                    continue
                with self._lock:
                    stats.idle_s += time.perf_counter() - t_wait
                items = [first]
                with self._lock:
                    bs = self.batch_sizes[stage.name]
                tr = self.tracer
                t_co = tr.now() if tr is not None else 0.0
                # deadline-triggered coalescing from the *shared* queue: wait
                # briefly for a full micro-batch, flush at once when the
                # stream is closed
                deadline = time.perf_counter() + self.coalesce_wait_s
                while len(items) < bs:
                    try:
                        left = deadline - time.perf_counter()
                        if left > 0 and not self._closed[si].is_set():
                            items.append(in_q.get(timeout=left))
                        else:
                            items.append(in_q.get_nowait())
                    except queue.Empty:
                        break
                if tr is not None:
                    tr.add_span(f"{stage.name}.coalesce", t_co, tr.now(),
                                cat="coalesce", tid=f"{stage.name}/r{rid}",
                                n=len(items), target=bs)
                if self._killed(si, rid):
                    # died holding a claimed batch: the items ride the
                    # requeue/fail path, exactly like a worker exception
                    self._requeue_or_fail(si, stats, items, ReplicaKilled(
                        f"{stage.name} replica {rid} killed mid-batch"))
                    break
                self._run_batch(si, rid, stage, stats, items, out_q)
        except BaseException as e:                   # noqa: BLE001
            self._fail(e)
        self._return_stage(si, stage)
        self._unregister(si, rid)
        self._retire(si)

    def _run_batch(self, si: int, rid: int, stage, stats: StageStats,
                   items: List[_ElasticItem], out_q: queue.Queue) -> None:
        qb = _batch_from_items(items)
        tr = self.tracer
        t0 = time.perf_counter()
        if tr is not None:
            t_svc = tr.now()
            for it in items:
                if it.t_enq > 0.0:
                    tr.add_span(f"{stage.name}.queue", it.t_enq, t_svc,
                                cat="queue", tid=f"{stage.name}/r{rid}",
                                req=it.idx, attempt=it.retries)
        if si == 0:
            for it in items:
                # anchor once, at the first service start: a requeued item
                # keeps its original dequeue time, so queue_wait measures
                # arrival -> first service and retry time lands in service
                if it.t_start == 0.0:
                    it.t_start = t0
        try:
            qb = stage.run(qb)
        except Exception as e:                       # noqa: BLE001
            dt = time.perf_counter() - t0
            # the failed attempt's service time must not vanish from the
            # per-request trace: attribute its per-item share now (the
            # retry's share accumulates on top via _scatter_to_items)
            share = dt / max(len(items), 1)
            for it in items:
                it.latency_s[stage.name] = \
                    it.latency_s.get(stage.name, 0.0) + share
            if tr is not None:
                te = tr.now()
                for it in items:
                    tr.add_span(stage.name, te - dt, te, cat="service",
                                tid=f"{stage.name}/r{rid}", req=it.idx,
                                replica=rid, attempt=it.retries,
                                error=type(e).__name__)
            with self._lock:
                stats.busy_s += dt
                stats.n_batches += 1
            self._requeue_or_fail(si, stats, items, e)
            return
        dt = time.perf_counter() - t0
        slow = self._slow_factor(si, rid)
        if slow > 1.0:
            time.sleep(dt * (slow - 1.0))   # injected straggler drag
            dt *= slow
        _scatter_to_items(qb, items)
        with self._lock:
            stats.busy_s += dt
            stats.n_batches += 1
            stats.n_items += len(items)
            self._straggler[si].record(rid, dt / max(len(items), 1))
        if tr is not None:
            te = tr.now()
            for it in items:
                tr.add_span(stage.name, te - dt, te, cat="service",
                            tid=f"{stage.name}/r{rid}", req=it.idx,
                            replica=rid, attempt=it.retries, n=len(items))
                it.t_enq = te
        t1 = time.perf_counter()
        for it in items:
            self._put_abortable(out_q, it)
        with self._lock:
            stats.stall_s += time.perf_counter() - t1

    # -- sink ---------------------------------------------------------------

    def _collector(self) -> None:
        out_q = self.queues[-1]
        while True:
            try:
                item = out_q.get(timeout=_POLL_S)
            except queue.Empty:
                if self._abort.is_set() or (self._closed[-1].is_set()
                                            and out_q.empty()):
                    return
                continue
            lat_ms = (time.perf_counter() - item.t_submit) * 1e3
            with self._lock:
                self._done.append(item)
                if item.failed:
                    # terminal failure: accounted, surfaced via on_done, but
                    # kept out of the latency window (no service happened)
                    self.n_failed += 1
                else:
                    self.n_completed += 1
                    self._recent_ms.append(lat_ms)
                    if len(self._recent_ms) > self._recent_cap:
                        del self._recent_ms[: -self._recent_cap]
            if item.on_done is not None:
                try:
                    item.on_done(item)
                except Exception as e:               # noqa: BLE001
                    self._fail(e)

    # -- serialized writer --------------------------------------------------

    def _wait_writer_stall(self) -> bool:
        """Sleep out an injected writer stall; False means abort observed."""
        while True:
            with self._lock:
                resume = self._writer_resume_t
                if resume is not None:
                    left = resume - time.perf_counter()
                    if left <= 0:
                        self._writer_resume_t = None
                        resume = None
            if resume is None:
                return True
            if self._abort.is_set():
                return False
            time.sleep(min(left, _POLL_S))

    def _writer_loop(self) -> None:
        try:
            while True:
                # injected writer stall: mutations back up while frozen,
                # then the backlog drains on resume (stay abort-aware)
                if not self._wait_writer_stall():
                    return
                try:
                    first = self._wq.get(timeout=_POLL_S)
                except queue.Empty:
                    if self._abort.is_set() or (self._writer_closed.is_set()
                                                and self._wq.empty()):
                        return
                    continue
                batch = [first]
                while len(batch) < self.mutation_batch:
                    try:
                        batch.append(self._wq.get_nowait())
                    except queue.Empty:
                        break
                # a stall injected while we blocked on get() must freeze
                # the already-coalesced batch too, not just the next one
                if not self._wait_writer_stall():
                    return
                tw = time.perf_counter()
                errs = self._apply_mutations([req for req, _ in batch])
                if self.tracer is not None:
                    dt = time.perf_counter() - tw
                    te = self.tracer.now()
                    self.tracer.add_span(
                        "writer.apply", te - dt, te, cat="writer",
                        tid="writer", n=len(batch),
                        failed=sum(1 for e in errs if e is not None))
                with self._lock:
                    self.write_batches.append(len(batch))
                    self.mutations_applied += \
                        sum(1 for e in errs if e is None)
                    self.mutations_failed += \
                        sum(1 for e in errs if e is not None)
                for (_, cb), err in zip(batch, errs):
                    if cb is not None:
                        cb(err)
        except BaseException as e:                   # noqa: BLE001
            self._fail(e)

    def _apply_mutations(self, reqs: List[Request]
                         ) -> List[Optional[BaseException]]:
        """Batched mutation application with **per-request** attribution:
        one chunking pass + one embedder call for every pending
        insert/update, then per-request application **in arrival order**
        under the DB's mutation lock — a batch holding
        [insert(d), removal(d)] must leave d absent, exactly as the
        sequential stream would.  Returns one error slot per request: a
        failure applying request *k* never claims requests already applied
        before it, and later requests still get their turn."""
        pipe = self.pipeline
        errs: List[Optional[BaseException]] = [None] * len(reqs)
        upserts: List[Request] = []
        per_doc: Dict[int, List[Chunk]] = {}
        with pipe.timer.stage("chunking"):
            for i, r in enumerate(reqs):
                if r.op not in ("insert", "update"):
                    continue
                try:
                    version = r.version or (1 if r.op == "update" else 0)
                    per_doc[id(r)] = [
                        Chunk(-1, r.doc_id, piece, s, e, version=version)
                        for s, e, piece in pipe.chunker.chunk(r.text)]
                    upserts.append(r)
                except Exception as e:               # noqa: BLE001
                    errs[i] = e
        flat = [c for chunks in per_doc.values() for c in chunks]
        vecs, embed_err = None, None
        if flat:
            try:
                with pipe.timer.stage("embedding"):
                    vecs = pipe.embedder.embed([c.text for c in flat])
            except Exception as e:                   # noqa: BLE001
                # the batched embed is shared; its failure claims every
                # upsert in the batch, but removals still proceed
                embed_err = e
        offsets: Dict[int, int] = {}
        ofs = 0
        for r in upserts:
            offsets[id(r)] = ofs
            ofs += len(per_doc[id(r)])
        for i, r in enumerate(reqs):
            if errs[i] is not None:
                continue
            try:
                if r.op == "removal":
                    pipe.remove_document(r.doc_id)
                    continue
                chunks = per_doc[id(r)]
                if not chunks:
                    if r.op == "update":    # empty replacement == removal
                        pipe.remove_document(r.doc_id)
                    continue
                if embed_err is not None:
                    raise embed_err
                sub = vecs[offsets[id(r)]:offsets[id(r)] + len(chunks)]
                with pipe.timer.stage("insertion"):
                    if r.op == "update":
                        pipe.db.update(r.doc_id, sub, chunks)
                    else:
                        pipe.db.insert(sub, chunks)
            except Exception as e:                   # noqa: BLE001
                errs[i] = e
        return errs

    # -- batch drive (StagedExecutor-compatible) ----------------------------

    def run(self, questions: Sequence[str],
            ground_truth: Optional[Sequence[str]] = None,
            gold_chunks: Optional[Sequence[List[int]]] = None
            ) -> ElasticResult:
        """Feed a query list through the pools and wait for completion;
        outputs are sorted back to submission order and identical to the
        lock-step path."""
        n = len(questions)
        self.start()
        t0 = time.perf_counter()
        for i, q in enumerate(questions):
            if self._abort.is_set():
                break
            self.submit(q,
                        ground_truth=ground_truth[i] if ground_truth else "",
                        gold=list(gold_chunks[i]) if gold_chunks else [])
        self.drain()
        wall = time.perf_counter() - t0
        with self._lock:
            done = sorted(self._done, key=lambda it: it.idx)
            write_batches = list(self.write_batches)
            n_failed, n_retried = self.n_failed, self.n_retried
            mut_applied = self.mutations_applied
            mut_failed = self.mutations_failed
        assert len(done) == n, f"lost items: {len(done)} != {n}"
        failed = [it for it in done if it.failed]
        if failed:
            # batch mode has no per-request error channel: surface the first
            # terminal failure (service-mode callers get per-item errors
            # through on_done instead)
            raise failed[0].error
        traces = traces_from_batch(
            _batch_from_items(done),
            latency_s=[dict(it.latency_s) for it in done],
            n_attempts=[it.retries + 1 for it in done])
        self.pipeline.traces.extend(traces)
        return ElasticResult(traces=traces, wall_s=wall,
                             throughput_qps=n / wall if wall > 0 else 0.0,
                             stage_stats=list(self.stats),
                             write_batches=write_batches,
                             n_failed=n_failed,
                             n_retried=n_retried,
                             mutations_applied=mut_applied,
                             mutations_failed=mut_failed)
