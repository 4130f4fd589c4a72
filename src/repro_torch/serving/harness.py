"""Serving harness: arrival schedule → continuous batcher → RAGPipeline
(the port of ``repro.serving.harness``).

Open-loop mode replays the configured arrival process in real time on an
injection thread while a single executor thread drains the batcher; queue
depth and in-flight counts evolve exactly as they would behind a real
endpoint (the pipeline itself is single-threaded, as one model replica is).
Closed-loop mode runs ``concurrency`` client threads that each keep one
request outstanding.

Passing an ``ElasticExecutor`` switches the backend: queries are injected
straight into the replicated stage graph (stage-level coalescing replaces
the request-level batcher) and index mutations ride the executor's
serialized writer path, while arrivals, accounting, and SLO bookkeeping stay
identical — so static and elastic serving are compared under the exact same
load schedule.

The harness exposes ``gauges()`` (queue depth / in-flight / peak batch size,
plus the elastic executor's per-stage gauges when one is attached) for
``ResourceMonitor.add_gauges`` so serving dynamics land in the same
time-series traces as RSS/CPU/device memory.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.core.pipeline import RAGPipeline
from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec
from repro_torch.metrics.quality import evaluate_traces, mean_quality_weight
from repro_torch.serving.accounting import LatencyAccountant, RequestRecord
from repro_torch.serving.arrival import ArrivalConfig, arrival_times
from repro_torch.serving.batcher import (BatchPolicy, ContinuousBatcher,
                                         Submission)
from repro_torch.workload.corpus import SyntheticCorpus
from repro_torch.workload.generator import (Request, WorkloadConfig,
                                            WorkloadGenerator)
from repro_torch.workload.runner import gold_chunks_for


def warm_up(pipeline) -> None:
    """One query through the pipeline before traffic, so first-call costs
    stay out of the measured tail. On the card it first compiles every
    kernel of ``csrc/`` that is not built yet (nvcc, once per checkout):
    the freshness scan's kernel, say, first launches only after a write.
    The generator's ``GenStats`` (and a token-level engine's counters) are
    left as the query found them: it is not a request of the run."""
    dev = getattr(pipeline.db, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    llm = pipeline.llm
    kept = [(obj, obj.copy()) for obj in (
        getattr(llm, "stats", None),
        getattr(getattr(llm, "engine", None), "counters", None))
        if hasattr(obj, "reset")]
    pipeline.query(["warmup query"])
    pipeline.traces.clear()
    for obj, before in kept:
        obj.reset(before)


@dataclass
class ServingConfig:
    arrival: ArrivalConfig = field(default_factory=ArrivalConfig)
    policy: BatchPolicy = field(default_factory=BatchPolicy)
    slo_ms: float = 500.0
    evaluate: bool = False
    time_scale: float = 1.0   # <1 compresses the schedule (tests/smoke)


@dataclass
class ServingResult:
    summary: Dict[str, float]
    records: List[RequestRecord]
    batch_sizes: List[int]
    peak_in_flight: int
    peak_queue_depth: int
    quality: Dict[str, float] = field(default_factory=dict)


class ServingHarness:
    """Drive a pipeline (or a ``PipelineSpec``, built here on ``device``:
    ``None`` means the card) under the configured arrival process."""

    def __init__(self, pipeline, corpus: SyntheticCorpus,
                 wcfg: WorkloadConfig, scfg: ServingConfig,
                 executor=None, tracer=None, device=None):
        if isinstance(pipeline, PipelineSpec):
            # spec path: the harness owns construction, so it also indexes
            # the corpus it is about to serve
            pipeline = build(pipeline, device=device)
            pipeline.index_documents(corpus.all_documents())
        self.pipeline: RAGPipeline = pipeline
        self.corpus = corpus
        self.wcfg = wcfg
        self.scfg = scfg
        self.executor = executor          # ElasticExecutor backend (optional)
        self.tracer = tracer              # optional obs.Tracer
        self.accountant = LatencyAccountant(slo_ms=scfg.slo_ms)
        self.batcher = ContinuousBatcher(scfg.policy)
        self.batch_sizes: List[int] = []
        self._in_flight = 0       # guarded-by: _if_lock
        self.peak_in_flight = 0   # guarded-by: _if_lock
        self._if_lock = threading.Lock()
        self._next_id = 0         # guarded-by: _if_lock
        self._outstanding: Dict[int, Submission] = {}  # guarded-by: _if_lock

    # -- monitor integration ----------------------------------------------

    def in_flight(self) -> int:
        with self._if_lock:
            return self._in_flight

    def gauges(self) -> Dict[str, Callable[[], float]]:
        out = {
            "serving_queue_depth": lambda: float(self.batcher.depth()),
            "serving_in_flight": lambda: float(self.in_flight()),
            "serving_last_batch": lambda: float(
                self.batch_sizes[-1] if self.batch_sizes else 0),
        }
        if self.executor is not None:
            out.update(self.executor.gauges())
        return out

    # -- submission --------------------------------------------------------

    def _submit(self, req: Request) -> Submission:
        now = time.perf_counter()
        with self._if_lock:
            rec = RequestRecord(req_id=self._next_id, op=req.op, arrival_s=now)
            self._next_id += 1
            self._in_flight += 1
            self.peak_in_flight = max(self.peak_in_flight, self._in_flight)
        sub = Submission(request=req, record=rec)
        if self.executor is not None:
            with self._if_lock:
                self._outstanding[rec.req_id] = sub
            self._submit_elastic(req, sub)
        else:
            self.batcher.submit(sub)
        return sub

    def _finish(self, sub: Submission, ok: bool,
                err: Optional[BaseException] = None) -> None:
        # idempotent: the abort watchdog / _drain_elastic failing leftovers
        # can race a concurrent on_done completion — first caller wins, the
        # loser must not double-decrement _in_flight or double-record
        with self._if_lock:
            if sub.finished:
                return
            sub.finished = True
        sub.record.end_s = time.perf_counter()
        if sub.record.start_s == 0.0:
            sub.record.start_s = sub.record.end_s
        sub.record.ok = ok
        sub.error = err
        tr = self.tracer
        if tr is not None:
            te = tr.now()
            tr.add_span("request", te - sub.record.latency_s, te,
                        cat="request", tid=f"request/{sub.record.op}",
                        req=sub.record.req_id, op=sub.record.op, ok=ok)
        self.accountant.observe(sub.record)
        with self._if_lock:
            self._in_flight -= 1
            self._outstanding.pop(sub.record.req_id, None)
        sub.done.set()

    # -- elastic backend ----------------------------------------------------

    def _submit_elastic(self, req: Request, sub: Submission) -> None:
        """Route one request into the ElasticExecutor: queries through the
        replica pools, mutations through the serialized writer."""
        if req.op == "query":
            def on_done(item, sub=sub, req=req):
                if item.failed:
                    # terminal failure after the retry budget: surfaced, not
                    # dropped — the record carries the error
                    self._finish(sub, ok=False, err=item.error)
                    return
                sub.record.start_s = item.t_start
                sub.record.stages = dict(item.latency_s)
                if self.scfg.evaluate:
                    # gold resolution happens off the arrival thread (it
                    # scans chunk payloads) and only when quality is wanted
                    item.gold = gold_chunks_for(self.pipeline.db,
                                                req.gold_doc_id, req.answer)
                    self.pipeline.traces.append(self.executor.trace_for(item))
                self._finish(sub, ok=True)

            self.executor.submit(req.question, ground_truth=req.answer,
                                 on_done=on_done)
        else:
            def on_write_done(err, sub=sub):
                # write latency is accounted end-to-end (arrival → applied);
                # the writer does not expose a dequeue timestamp
                self._finish(sub, ok=err is None, err=err)

            self.executor.submit_mutation(req, on_done=on_write_done)

    # -- execution ---------------------------------------------------------

    def _execute_batch(self, batch: List[Submission]) -> None:
        t_start = time.perf_counter()
        for sub in batch:
            sub.record.start_s = t_start
            sub.record.batch_size = len(batch)
        self.batch_sizes.append(len(batch))
        stage_before = self.pipeline.timer.breakdown()
        try:
            if batch[0].request.op == "query":
                reqs = [s.request for s in batch]
                golds = [gold_chunks_for(self.pipeline.db, r.gold_doc_id,
                                         r.answer) for r in reqs]
                self.pipeline.query([r.question for r in reqs],
                                    ground_truth=[r.answer for r in reqs],
                                    gold_chunks=golds)
            else:
                req = batch[0].request
                if req.op == "insert":
                    self.pipeline.index_documents([(req.doc_id, req.text)],
                                                  build=False)
                elif req.op == "update":
                    # version captured at stream-generation time: the whole
                    # stream is materialized before execution, so reading
                    # corpus.versions here would see the final count
                    self.pipeline.update_document(req.doc_id, req.text,
                                                  version=req.version or 1)
                elif req.op == "removal":
                    self.pipeline.remove_document(req.doc_id)
        except Exception as e:                      # noqa: BLE001
            for sub in batch:
                self._finish(sub, ok=False, err=e)
            return
        stage_after = self.pipeline.timer.breakdown()
        share = {k: (stage_after.get(k, 0.0) - stage_before.get(k, 0.0))
                 / len(batch)
                 for k in stage_after
                 if stage_after.get(k, 0.0) > stage_before.get(k, 0.0)}
        for sub in batch:
            sub.record.stages = dict(share)
            self._finish(sub, ok=True)

    def _executor_loop(self) -> None:
        while True:
            batch = self.batcher.get_batch()
            if batch is None:
                return
            self._execute_batch(batch)

    # -- drive modes -------------------------------------------------------

    def _materialize(self) -> List[Request]:
        gen = WorkloadGenerator(self.wcfg, self.corpus)
        return list(gen.requests())

    def run(self) -> ServingResult:
        acfg = self.scfg.arrival
        requests = self._materialize()
        executor: Optional[threading.Thread] = None
        watchdog: Optional[threading.Thread] = None
        stop_watch = threading.Event()
        if self.executor is not None:
            self.executor.start()
            # closed-loop clients park on sub.done; if the backend aborts
            # mid-run nothing would ever complete them — the watchdog fails
            # outstanding submissions the moment abort is observed
            watchdog = threading.Thread(target=self._abort_watchdog,
                                        args=(stop_watch,),
                                        name="ragperf-serving-watchdog")
            watchdog.start()
        else:
            executor = threading.Thread(target=self._executor_loop,
                                        name="ragperf-serving-executor")
            executor.start()
        offered: Optional[float] = None
        try:
            if acfg.mode == "open":
                offered = acfg.target_qps / max(self.scfg.time_scale, 1e-9)
                self._drive_open(requests)
            else:
                self._drive_closed(requests)
        finally:
            if self.executor is not None:
                try:
                    self._drain_elastic()
                finally:
                    stop_watch.set()
                    watchdog.join()
            else:
                self.batcher.close()
                executor.join()
        summary = self.accountant.summary(offered_qps=offered)
        with self._if_lock:
            peak_in_flight = self.peak_in_flight
        summary["peak_in_flight"] = float(peak_in_flight)
        peak_depth = self.batcher.peak_depth
        if self.executor is not None:
            # the elastic backend bypasses the batcher; deepest stage queue
            # is the comparable backlog figure
            peak_depth = int(max((s.queue_depth_max
                                  for s in self.executor.stats), default=0))
        summary["peak_queue_depth"] = float(peak_depth)
        if self.batch_sizes:
            summary["mean_batch_size"] = (sum(self.batch_sizes)
                                          / len(self.batch_sizes))
            summary["max_batch_size"] = float(max(self.batch_sizes))
        quality: Dict[str, float] = {}
        if self.scfg.evaluate and self.pipeline.traces:
            quality = evaluate_traces(self.pipeline.traces, self.pipeline.db)
            if "goodput_qps" in summary:
                # quality-aware SLO goodput: discount goodput by the mean
                # per-request quality weight, so a knob-ladder "win" that
                # held latency by degrading recall/answers is priced in
                w = mean_quality_weight(self.pipeline.traces)
                summary["quality_weight_mean"] = w
                summary["quality_goodput_qps"] = summary["goodput_qps"] * w
        return ServingResult(summary=summary,
                             records=list(self.accountant.records),
                             batch_sizes=list(self.batch_sizes),
                             peak_in_flight=peak_in_flight,
                             peak_queue_depth=peak_depth,
                             quality=quality)

    def _abort_watchdog(self, stop: threading.Event) -> None:
        while not stop.wait(0.02):
            if self.executor.aborted():
                self._fail_outstanding(self.executor.error
                                       or RuntimeError("executor aborted"))
                return

    def _fail_outstanding(self, err: Optional[BaseException]) -> None:
        with self._if_lock:
            leftovers = list(self._outstanding.values())
        for sub in leftovers:
            self._finish(sub, ok=False, err=err)

    def _drain_elastic(self) -> None:
        """Wait out the elastic executor; if it aborted, fail whatever is
        still outstanding so closed-loop clients and callers never hang."""
        err: Optional[BaseException] = None
        try:
            self.executor.drain()
        except BaseException as e:                    # noqa: BLE001
            err = e
        self._fail_outstanding(err)
        if err is not None:
            raise err

    def _drive_open(self, requests: List[Request]) -> None:
        acfg = self.scfg.arrival
        times = arrival_times(acfg) * self.scfg.time_scale
        t0 = time.perf_counter()
        for req, t_arr in zip(requests, times):
            delay = (t0 + t_arr) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            self._submit(req)

    def _drive_closed(self, requests: List[Request]) -> None:
        acfg = self.scfg.arrival
        it: Iterator[Request] = iter(requests)
        it_lock = threading.Lock()

        def client() -> None:
            while True:
                with it_lock:
                    req = next(it, None)
                if req is None:
                    return
                sub = self._submit(req)
                sub.done.wait()

        clients = [threading.Thread(target=client,
                                    name=f"ragperf-serving-client-{i}")
                   for i in range(acfg.concurrency)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
