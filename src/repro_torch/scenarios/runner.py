"""ScenarioRunner: one entry point, two execution modes, one report schema.

* ``simulate()`` — the wall-clock-free mode: the seeded stream drives the
  discrete-event queueing model (``repro_torch.scenarios.sim``) and the real
  ``AutoscaleController``; the resulting per-query knob levels are then
  **replayed against the real pipeline** (knobs applied at the simulated
  ladder level, mutations applied in stream order) so retrieval/answer
  quality is measured, not modeled.  Fully deterministic: the same spec
  gives the same report in this package and in the reference, and on the
  card and on the CPU.
* ``serve()`` — the live mode: the same spec mapped onto the real
  ``ServingHarness`` (elastic executor + controller when the scenario's
  autoscale block is enabled).  Real tails, statistically-but-not-bitwise
  reproducible.

Both emit a ``ScenarioReport`` with the same schema, and both price quality
into goodput: **quality-aware goodput** counts each SLO-meeting query at its
quality weight (gold-context hit × answer F1 — ``metrics.quality``), so a
knob-ladder "win" that held latency by degrading recall is charged for it.

The pipeline is built on ``device`` (``None`` means the card).  The
reference's golden-trace files stay with the reference: this package never
reads or writes them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.registry import build
from repro_torch.core.stages import GenerateStage, RerankStage, RetrieveStage
from repro_torch.metrics.quality import evaluate_traces, trace_quality
from repro_torch.serving.accounting import percentile
from repro_torch.serving.arrival import arrival_times
from repro_torch.serving.autoscale import AutoscaleConfig, AutoscaleController
from repro_torch.serving.batcher import BatchPolicy
from repro_torch.serving.elastic import ElasticExecutor
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.harness import (ServingConfig, ServingHarness,
                                         warm_up)
from repro_torch.serving.staged import StagedExecutor
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
from repro_torch.workload.generator import Request, WorkloadGenerator
from repro_torch.workload.runner import gold_chunks_for

from repro_torch.obs import decomposition_summary
from repro_torch.scenarios.sim import CostModel, ScenarioSim
from repro_torch.scenarios.spec import ScenarioSpec


@dataclass
class ScenarioReport:
    """The unified scenario result schema (sim and live)."""

    scenario: str
    mode: str                        # sim | live
    seed: int
    n_requests: int
    summary: Dict[str, float]
    quality: Dict[str, float] = field(default_factory=dict)
    scaling_events: List[Dict] = field(default_factory=list)
    knob_timeline: List[Dict] = field(default_factory=list)
    stage_report: List[Dict] = field(default_factory=list)
    fault_events: List[Dict] = field(default_factory=list)
    deterministic_replay: bool = True
    # critical-path breakdown: queue + per-stage service p50/p95 (ms),
    # computed from per-request component decomposition (repro_torch.obs)
    trace_decomposition: Dict[str, Dict[str, float]] = field(
        default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {
            "scenario": self.scenario, "mode": self.mode, "seed": self.seed,
            "n_requests": self.n_requests, "summary": self.summary,
            "quality": self.quality, "scaling_events": self.scaling_events,
            "knob_timeline": self.knob_timeline,
            "stage_report": self.stage_report,
            "fault_events": self.fault_events,
            "deterministic_replay": self.deterministic_replay,
            "trace_decomposition": self.trace_decomposition,
        }


def apply_knob_step(pipe, step) -> None:
    """Set a quality-ladder step's knobs on a live pipeline (the same knob
    surface ``ElasticExecutor.apply_knobs`` drives, minus the executor)."""
    nprobe, rerank_k = int(step[0]), int(step[1])
    for st in pipe.stages:
        if isinstance(st, RetrieveStage) and hasattr(st.db, "set_nprobe"):
            st.db.set_nprobe(nprobe)
        elif isinstance(st, RerankStage):
            st.rerank_k = max(1, rerank_k)
        elif isinstance(st, GenerateStage) and len(step) > 2 \
                and hasattr(st.llm, "set_max_new"):
            st.llm.set_max_new(int(step[2]))


class ScenarioRunner:
    def __init__(self, spec: ScenarioSpec, device=None):
        self.spec = spec
        self.device = device
        self.pipeline = None     # the last run's pipeline (its traces, DB)

    # -- shared construction -------------------------------------------------

    def _build(self):
        """Fresh (pipeline, corpus) with the corpus indexed — before the
        stream is materialized, because update ops mutate corpus facts."""
        spec = self.spec
        corpus = SyntheticCorpus(CorpusConfig(n_docs=spec.n_docs,
                                              seed=spec.seed))
        pipe = build(spec.pipeline_spec(), device=self.device)
        pipe.index_documents(corpus.all_documents())
        return pipe, corpus

    def _materialize(self, corpus) -> List[Request]:
        gen = WorkloadGenerator(self.spec.workload_config(), corpus)
        return list(gen.requests())

    def _autoscale_config(self) -> Optional[AutoscaleConfig]:
        spec = self.spec
        if not spec.autoscale.enabled:
            return None
        pspec = spec.pipeline_spec()
        acfg = AutoscaleConfig.from_spec(
            spec.autoscale,
            base_nprobe=int(pspec.vectordb.options.get("nprobe", 0) or 0),
            base_rerank_k=pspec.rerank_k,
            base_max_new=int(pspec.llm.options.get("max_new", 0) or 0))
        acfg.slo_ms = spec.slo_ms       # the scenario's SLO is the SLO
        return acfg

    # -- deterministic simulation ---------------------------------------------

    def simulate(self, cost: Optional[CostModel] = None,
                 tracer=None) -> ScenarioReport:
        spec = self.spec
        assert spec.arrival.mode == "open", \
            "simulate() models open-loop scenarios (closed loop is live-only)"
        pipe, corpus = self._build()
        self.pipeline = pipe
        requests = self._materialize(corpus)
        times = arrival_times(spec.arrival_config())
        n = min(len(requests), len(times))
        requests = requests[:n]
        acfg = self._autoscale_config()
        pspec = spec.pipeline_spec()
        n_shards = (int(pspec.vectordb.options.get("n_shards", 1) or 1)
                    if pspec.vectordb.component == "torch_sharded" else 1)
        if n_shards > 1:
            cost = dataclasses.replace(cost or CostModel(), shards=n_shards)
        sim = ScenarioSim(requests, times[:n], acfg,
                          replicas=pspec.stage_replicas(),
                          batch_sizes=pspec.stage_batch_sizes(),
                          cost=cost, faults=spec.faults, tracer=tracer)
        res = sim.run()

        # quality replay: real pipeline, stream order, knobs pinned to each
        # query's simulated ladder level; terminally-failed queries never
        # produced an answer, so they are excluded (and priced into
        # availability instead)
        failed_idx = {q.stream_idx for q in res.failed}
        ladder = list(acfg.ladder) if acfg is not None else []
        level_of = {q.stream_idx: q.level for q in res.queries}
        traces: List = []
        pend: List[Request] = []
        pend_level = 0
        cur_level = 0

        def flush():
            nonlocal cur_level
            if not pend:
                return
            if ladder and pend_level != cur_level:
                apply_knob_step(pipe, ladder[pend_level])
                cur_level = pend_level
            golds = [gold_chunks_for(pipe.db, r.gold_doc_id, r.answer)
                     for r in pend]
            traces.extend(pipe.query([r.question for r in pend],
                                     ground_truth=[r.answer for r in pend],
                                     gold_chunks=golds))
            pend.clear()

        for i, req in enumerate(requests):
            if req.op == "query":
                if i in failed_idx:
                    continue
                lvl = level_of[i]
                if pend and (lvl != pend_level or len(pend) >= 8):
                    flush()
                if not pend:
                    pend_level = lvl
                pend.append(req)
                continue
            flush()
            if req.op == "insert":
                pipe.index_documents([(req.doc_id, req.text)], build=False)
            elif req.op == "update":
                pipe.update_document(req.doc_id, req.text,
                                     version=req.version or 1)
            else:
                pipe.remove_document(req.doc_id)
        flush()

        assert len(traces) == len(res.queries), \
            f"replay lost queries: {len(traces)} != {len(res.queries)}"
        weights = [trace_quality(t) for t in traces]
        lat_ms = [q.latency_s * 1e3 for q in res.queries]
        wall = res.wall_s
        good = [w for q, w in zip(res.queries, weights)
                if q.latency_s * 1e3 <= spec.slo_ms]
        summary: Dict[str, float] = {
            "n_requests": float(n),
            "n_queries": float(len(res.queries)),
            "n_mutations": float(len(res.mutation_latencies_s)),
            "wall_s": wall,
            "offered_qps": spec.arrival.target_qps,
            "achieved_qps": len(res.queries) / wall,
            "slo_ms": spec.slo_ms,
            # every request is terminal (completed or explicitly failed)
            "n_failed": float(len(res.failed)),
            "n_retried": float(res.n_retried),
            "error_rate": len(res.failed) / n if n else 0.0,
            "availability": (n - len(res.failed)) / n if n else 1.0,
        }
        if lat_ms:
            for q_ in (50, 95, 99):
                summary[f"p{q_}_latency_ms"] = percentile(lat_ms, q_)
            summary["mean_latency_ms"] = sum(lat_ms) / len(lat_ms)
            summary["slo_attainment"] = len(good) / len(lat_ms)
            summary["goodput_qps"] = len(good) / wall
            summary["quality_weight_mean"] = sum(weights) / len(weights)
            summary["quality_goodput_qps"] = sum(good) / wall
        if res.mutation_latencies_s:
            summary["p95_mutation_latency_ms"] = percentile(
                [x * 1e3 for x in res.mutation_latencies_s], 95)
        ctl = res.controller
        det = True
        events: List[Dict] = []
        timeline: List[Dict] = []
        if ctl is not None:
            events = ctl.event_dicts()
            timeline = ctl.knob_timeline()
            det = [e.to_dict() for e in ctl.replay_events()] == events
        return ScenarioReport(
            scenario=spec.name, mode="sim", seed=spec.seed, n_requests=n,
            summary=summary, quality=evaluate_traces(traces, pipe.db),
            scaling_events=events, knob_timeline=timeline,
            stage_report=res.stage_rows, fault_events=res.fault_log,
            deterministic_replay=det,
            trace_decomposition=decomposition_summary(
                [(q.latency_s, q.stage_s) for q in res.queries]))

    # -- live serving --------------------------------------------------------

    def serve(self, time_scale: float = 1.0, batch: int = 8,
              batch_timeout_s: float = 0.005, tracer=None) -> ScenarioReport:
        spec = self.spec
        pipe, corpus = self._build()
        self.pipeline = pipe
        warm_up(pipe)
        scfg = ServingConfig(
            arrival=spec.arrival_config(),
            policy=BatchPolicy(max_batch=batch, max_wait_s=batch_timeout_s,
                               priority=spec.priority),
            slo_ms=spec.slo_ms, evaluate=True, time_scale=time_scale)
        executor = controller = injector = None
        acfg = self._autoscale_config()
        if acfg is not None:
            pspec = spec.pipeline_spec()
            executor = ElasticExecutor(
                pipe, replicas=pspec.stage_replicas(),
                batch_sizes=pspec.stage_batch_sizes(), default_batch=batch,
                max_replicas=spec.autoscale.max_replicas,
                max_retries=spec.faults.max_retries,
                straggler_tolerance=(spec.faults.straggler_tolerance
                                     if spec.faults.detect else 0.0),
                straggler_window=spec.faults.straggler_window,
                tracer=tracer)
            controller = AutoscaleController(acfg, executor=executor)
            if spec.faults.enabled:
                injector = FaultInjector(executor, spec.faults,
                                         time_scale=time_scale)
        harness = ServingHarness(pipe, corpus, spec.workload_config(), scfg,
                                 executor=executor, tracer=tracer)
        if controller is not None:
            controller.start()
        if injector is not None:
            injector.start()
        try:
            res = harness.run()
        finally:
            if injector is not None:
                injector.stop()
            if controller is not None:
                controller.stop()
        events: List[Dict] = []
        timeline: List[Dict] = []
        stage_rows: List[Dict] = []
        fault_events: List[Dict] = []
        det = True
        if controller is not None:
            events = controller.event_dicts()
            timeline = controller.knob_timeline()
            stage_rows = [st.row() for st in executor.stats]
            det = [e.to_dict()
                   for e in controller.replay_events()] == events
        if injector is not None:
            fault_events = injector.applied_events()
        return ScenarioReport(
            scenario=spec.name, mode="live", seed=spec.seed,
            n_requests=int(res.summary.get("n_requests", 0)),
            summary=res.summary, quality=res.quality,
            scaling_events=events, knob_timeline=timeline,
            stage_report=stage_rows, fault_events=fault_events,
            deterministic_replay=det,
            trace_decomposition=decomposition_summary(
                [(r.latency_s, r.stages) for r in res.records
                 if r.op == "query" and r.ok]))

    # -- cross-executor equivalence (the test-matrix surface) ----------------

    def replay_outputs(self, executor: str, batch: int = 4) -> List:
        """Per-request query outputs under one executor regime.

        The one interleaving every executor can express identically is a
        phase split: all mutations applied in stream order first, then all
        queries in stream order — lock-step folds batches through the stage
        graph, ``staged`` pipelines one worker per stage, ``elastic`` runs
        replica pools.  Identical traces across the three is the scheduling-
        freedom-never-semantics contract, per scenario stream.
        """
        assert executor in ("lockstep", "staged", "elastic"), executor
        pipe, corpus = self._build()
        requests = self._materialize(corpus)
        for req in requests:
            if req.op == "insert":
                pipe.index_documents([(req.doc_id, req.text)], build=False)
            elif req.op == "update":
                pipe.update_document(req.doc_id, req.text,
                                     version=req.version or 1)
            elif req.op == "removal":
                pipe.remove_document(req.doc_id)
        queries = [r for r in requests if r.op == "query"]
        qs = [r.question for r in queries]
        ans = [r.answer for r in queries]
        golds = [gold_chunks_for(pipe.db, r.gold_doc_id, r.answer)
                 for r in queries]
        pipe.traces.clear()
        if executor == "lockstep":
            out = []
            for lo in range(0, len(qs), batch):
                out.extend(pipe.query(qs[lo:lo + batch],
                                      ground_truth=ans[lo:lo + batch],
                                      gold_chunks=golds[lo:lo + batch]))
            return out
        if executor == "staged":
            return StagedExecutor(pipe, default_batch=batch).run(
                qs, ground_truth=ans, gold_chunks=golds).traces
        return ElasticExecutor(pipe,
                               replicas={"retrieval": 2, "generation": 2},
                               default_batch=batch, max_replicas=4).run(
            qs, ground_truth=ans, gold_chunks=golds).traces
