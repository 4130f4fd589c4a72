"""Wall-clock-free scenario simulation (the port of ``repro.scenarios.sim``).

Live serving runs measure real thread scheduling, so their event streams are
only statistically reproducible.  ``ScenarioSim`` replaces wall time with
**virtual time**: a discrete-event queueing model of the elastic stage graph
(per-stage replica pools, micro-batch coalescing, a single serialized
mutation writer) driven by the *real* seeded arrival schedule, the *real*
seeded workload stream, and the *real* ``AutoscaleController.step`` — which
is wall-clock-free by contract, so the whole loop

    arrivals → queueing → snapshots → controller → scaling/knob events →
    queueing ...

is a pure function of ``(ScenarioSpec, CostModel)``.  Same seed ⇒ identical
scaling-event stream, knob timeline, latency distribution, and (after the
runner's quality replay) quality-aware goodput — the determinism the
reference's golden traces pin, and the port's simulation reproduces.

The cost model is deliberately simple: each stage batch costs
``base_s + per_item_s · n · knob_factor`` virtual seconds, where the knob
factor scales retrieval with ``nprobe``, rerank with ``rerank_k`` and
generation with ``max_new`` relative to the scenario's configured baseline —
the first-order shape of the real kernels, and exactly the levers the
quality ladder trades on.

Fault modeling mirrors the live executor's chaos contract in virtual time:
replica pools are **slots with stable rids** (spawn = fresh monotonic rid,
lowest idle rid serves first), a ``replica_kill`` dooms its slot — the
in-flight batch's items requeue at the queue head with a ``max_retries``
budget, then fail terminally — and a respawn arrives ``respawn_delay_s``
later; a ``replica_stall`` multiplies that slot's service time (feeding a
``StragglerDetector`` when detection is on, so the controller's ``retire``
events land in the same deterministic stream as scaling); a ``writer_stall``
freezes the serialized writer and lets the backlog drain on resume.  All of
it is heap events, so recovery timelines are bit-deterministic.
"""
# analysis: deterministic -- virtual time only
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.spec import QUERY_STAGE_NAMES
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.serving.accounting import percentile
from repro_torch.serving.autoscale import (AutoscaleConfig,
                                           AutoscaleController, Snapshot,
                                           StageSample)
from repro_torch.serving.faults import FaultSpec
from repro_torch.workload.generator import Request

STAGE_NAMES = tuple(QUERY_STAGE_NAMES.values())


@dataclass
class CostModel:
    """Virtual service costs (seconds) for the queueing model."""

    base_s: Dict[str, float] = field(default_factory=lambda: {
        "query_embed": 0.0003, "retrieval": 0.0008,
        "rerank": 0.0003, "generation": 0.0015})
    per_item_s: Dict[str, float] = field(default_factory=lambda: {
        "query_embed": 0.00005, "retrieval": 0.0035,
        "rerank": 0.0002, "generation": 0.0012})
    mutation_base_s: float = 0.001
    mutation_s: float = 0.02        # per op inside a coalesced write batch
    mutation_batch: int = 8
    # (the reference's shard and corpus-scale cost terms come with the
    # sharded DB, ROADMAP.md queue 1 item 6)


@dataclass
class SimQuery:
    """One query's virtual lifecycle (plus its stream position)."""

    stream_idx: int                 # index into the materialized stream
    t_arrive: float
    t_done: float = 0.0
    level: int = 0                  # quality-ladder level at retrieval start
    retries: int = 0                # requeues survived (replica kills)
    failed: bool = False            # terminal failure (retry budget spent)
    t_enq: float = 0.0              # when the query last entered a queue
    # accumulated per-stage service share (svc/n per batch, every attempt) —
    # the virtual-time mirror of StageTrace.latency_s, and the input to the
    # report's trace_decomposition block
    stage_s: Dict[str, float] = field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrive


@dataclass
class SimResult:
    queries: List[SimQuery]         # completed OK, stream order
    mutation_latencies_s: List[float]
    controller: Optional[AutoscaleController]
    wall_s: float
    stage_rows: List[Dict[str, float]]
    write_batches: List[int]
    failed: List[SimQuery] = field(default_factory=list)  # terminal failures
    fault_log: List[Dict[str, object]] = field(default_factory=list)
    n_retried: int = 0


class ScenarioSim:
    """Discrete-event simulation of one open-loop scenario pass.

    ``requests``/``arrivals`` are the materialized stream (zipped and
    truncated exactly as ``ServingHarness`` does); ``acfg`` is the autoscale
    controller config (``None`` disables control — one replica per stage,
    knobs pinned at level 0).
    """

    def __init__(self, requests: List[Request], arrivals,
                 acfg: Optional[AutoscaleConfig],
                 replicas: Optional[Dict[str, int]] = None,
                 batch_sizes: Optional[Dict[str, int]] = None,
                 default_batch: int = 8,
                 cost: Optional[CostModel] = None,
                 faults: Optional[FaultSpec] = None,
                 tracer=None):
        self.requests = requests
        # optional obs.Tracer; spans are recorded at explicit *virtual*
        # times, so two runs of the same spec produce bit-identical traces
        self.tracer = tracer
        self.arrivals = [float(t) for t in arrivals]
        self.cost = cost if cost is not None else CostModel()
        self.controller = (AutoscaleController(acfg)
                           if acfg is not None else None)
        self.ladder: List[Tuple[int, ...]] = (list(acfg.ladder)
                                              if acfg is not None else [])
        self.interval_s = acfg.interval_s if acfg is not None else 0.0
        rep = replicas or {}
        over = batch_sizes or {}
        self.replicas = {s: max(1, int(rep.get(s, 1))) for s in STAGE_NAMES}
        self.batch = {s: int(over.get(s, 0) or default_batch)
                      for s in STAGE_NAMES}
        # per-stage queue / pool state — pools are slots with stable rids:
        # lowest idle rid serves first, spawns mint fresh monotonic rids,
        # so fault targeting and recovery are deterministic
        self._pending: Dict[str, List[SimQuery]] = {s: [] for s in STAGE_NAMES}
        self._free: Dict[str, List[int]] = {
            s: list(range(self.replicas[s])) for s in STAGE_NAMES}
        self._next_rid: Dict[str, int] = {s: self.replicas[s]
                                          for s in STAGE_NAMES}
        self._busy_items: Dict[Tuple[str, int], List[SimQuery]] = {}
        self._doomed: set = set()          # (stage, rid) killed while busy
        self._shrink_pend = {s: 0 for s in STAGE_NAMES}  # retire on done
        self._slow: Dict[Tuple[str, int], float] = {}    # straggler factors
        self._busy = {s: 0.0 for s in STAGE_NAMES}
        self._cap = {s: 0.0 for s in STAGE_NAMES}
        self._n_batches = {s: 0 for s in STAGE_NAMES}
        self._n_items = {s: 0 for s in STAGE_NAMES}
        self._depth_max = {s: 0 for s in STAGE_NAMES}
        # chaos state
        self.faults = faults if faults is not None else FaultSpec()
        self.max_retries = self.faults.max_retries
        self.fault_log: List[Dict[str, object]] = []
        self.failed: List[SimQuery] = []
        self.n_retried = 0
        self._detect = [None] * len(STAGE_NAMES)
        if self.faults.detect:
            self._detect = [StragglerDetector(
                window=self.faults.straggler_window,
                tolerance=self.faults.straggler_tolerance,
                min_samples=2) for _ in STAGE_NAMES]
        # serialized writer
        self._wq: List[Tuple[float, Request]] = []
        self._writer_busy = False
        self._wstall_until = 0.0
        self.write_batches: List[int] = []
        self.mutation_latencies: List[float] = []
        # completion tracking
        self.queries: List[SimQuery] = []
        self._done = 0
        self._total = 0
        # small rolling window so the controller's p95 tracks *recent*
        # completions and recovery (ladder step-up) is observable within a
        # scenario-length stream
        self._recent_ms: List[float] = []
        self._recent_cap = 64
        # event heap: (t, seq, kind, payload); seq breaks ties reproducibly
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._now = 0.0

    # -- knobs ---------------------------------------------------------------

    def _level(self) -> int:
        return self.controller.level if self.controller is not None else 0

    def _knob_factor(self, stage: str) -> float:
        """Service-cost multiplier of the current ladder step vs step 0."""
        if not self.ladder or self._level() == 0:
            return 1.0
        base, cur = self.ladder[0], self.ladder[self._level()]
        if stage == "retrieval":
            return cur[0] / max(base[0], 1)
        if stage == "rerank":
            return cur[1] / max(base[1], 1)
        if stage == "generation" and len(base) > 2:
            return cur[2] / max(base[2], 1)
        return 1.0

    # -- event plumbing ------------------------------------------------------

    def _push(self, t: float, kind: str, payload: object = None) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def _advance(self, t: float) -> None:
        """Accumulate replica-seconds of capacity up to virtual time t."""
        dt = t - self._now
        if dt > 0:
            for s in STAGE_NAMES:
                self._cap[s] += self.replicas[s] * dt
        self._now = t

    # -- stage pools ---------------------------------------------------------

    def _start_batches(self, stage: str) -> None:
        cost = self.cost
        while self._free[stage] and self._pending[stage]:
            rid = self._free[stage].pop(0)       # lowest idle rid first
            n = min(self.batch[stage], len(self._pending[stage]))
            items = self._pending[stage][:n]
            del self._pending[stage][:n]
            if stage == "retrieval":
                lvl = self._level()
                for it in items:
                    it.level = lvl
            svc = (cost.base_s[stage]
                   + cost.per_item_s[stage] * n * self._knob_factor(stage))
            svc *= self._slow.get((stage, rid), 1.0)   # straggler drag
            self._busy[stage] += svc
            self._n_batches[stage] += 1
            self._n_items[stage] += n
            self._busy_items[(stage, rid)] = items
            share = svc / max(n, 1)
            tr = self.tracer
            for it in items:
                it.stage_s[stage] = it.stage_s.get(stage, 0.0) + share
                if tr is not None:
                    tr.add_span(f"{stage}.queue", it.t_enq, self._now,
                                cat="queue", tid=f"{stage}/r{rid}",
                                req=it.stream_idx)
                    tr.add_span(stage, self._now, self._now + svc,
                                cat="service", tid=f"{stage}/r{rid}",
                                req=it.stream_idx, replica=rid, n=n)
            if self._detect[STAGE_NAMES.index(stage)] is not None:
                self._detect[STAGE_NAMES.index(stage)].record(
                    rid, svc / max(n, 1))
            self._push(self._now + svc, "done", (stage, rid))

    # -- replica slots (chaos model) ----------------------------------------

    def _alive_rids(self, stage: str) -> List[int]:
        busy = [r for (s, r) in self._busy_items if s == stage
                and (s, r) not in self._doomed]
        return sorted(self._free[stage] + busy)

    def _spawn_slot(self, stage: str) -> int:
        rid = self._next_rid[stage]
        self._next_rid[stage] += 1
        self._free[stage].append(rid)
        self._free[stage].sort()
        self.replicas[stage] += 1
        return rid

    def _kill_slot(self, stage: str, rid: int) -> None:
        """Remove one slot; a busy victim's batch requeues at the queue head
        with the retry budget, exactly like the live executor's kill path."""
        self.replicas[stage] = max(0, self.replicas[stage] - 1)
        self._slow.pop((stage, rid), None)
        det = self._detect[STAGE_NAMES.index(stage)]
        if det is not None:
            det.forget(rid)
        if rid in self._free[stage]:
            self._free[stage].remove(rid)
            return
        items = self._busy_items.get((stage, rid))
        if items is None:
            return
        self._doomed.add((stage, rid))       # its done event is discarded
        survivors: List[SimQuery] = []
        tr = self.tracer
        for it in items:
            it.retries += 1
            if it.retries > self.max_retries:
                it.failed = True
                it.t_done = self._now
                self.failed.append(it)
                self._done += 1
                if tr is not None:
                    tr.instant("fail", t=self._now, cat="retry", tid=stage,
                               req=it.stream_idx, attempts=it.retries)
            else:
                self.n_retried += 1
                it.t_enq = self._now
                survivors.append(it)
                if tr is not None:
                    tr.instant("requeue", t=self._now, cat="retry", tid=stage,
                               req=it.stream_idx, attempt=it.retries)
        self._pending[stage][:0] = survivors
        self._start_batches(stage)

    def _retire_slot(self, stage: str, rid: int) -> None:
        """Controller retire: kill the flagged slot, spawn a fresh one —
        net pool width unchanged."""
        if rid not in self._alive_rids(stage):
            return
        self._kill_slot(stage, rid)
        self._spawn_slot(stage)
        self._start_batches(stage)

    def _set_alive(self, stage: str, n: int) -> None:
        """Controller replica scaling on the slot model: grow mints fresh
        rids; shrink removes idle slots (highest rid first) and lets busy
        ones finish their current batch before retiring ('done' handles
        ``_shrink_pend``) — matching the live executor's drain-then-exit."""
        while self.replicas[stage] < n:
            self._spawn_slot(stage)
        excess = self.replicas[stage] - n
        while excess > 0 and self._free[stage]:
            rid = self._free[stage].pop()     # idle victims: highest rid
            self._slow.pop((stage, rid), None)
            excess -= 1
        self._shrink_pend[stage] += excess
        self.replicas[stage] = n

    def _start_writes(self) -> None:
        if self._writer_busy or not self._wq or self._now < self._wstall_until:
            return
        n = min(self.cost.mutation_batch, len(self._wq))
        batch = self._wq[:n]
        del self._wq[:n]
        self._writer_busy = True
        self.write_batches.append(n)
        svc = self.cost.mutation_base_s + self.cost.mutation_s * n
        if self.tracer is not None:
            self.tracer.add_span("writer.apply", self._now, self._now + svc,
                                 cat="writer", tid="writer", n=n)
        self._push(self._now + svc, "wdone", batch)

    # -- controller ticks ----------------------------------------------------

    def _snapshot(self) -> Snapshot:
        stages = []
        for s in STAGE_NAMES:
            idle = max(self._cap[s] - self._busy[s], 0.0)
            stages.append(StageSample(
                name=s, busy_s=self._busy[s], idle_s=idle, stall_s=0.0,
                queue_depth=float(len(self._pending[s])),
                replicas=self.replicas[s], batch_size=self.batch[s]))
        stragglers: List[Tuple[str, int]] = []
        for si, s in enumerate(STAGE_NAMES):
            if self._detect[si] is not None:
                stragglers += [(s, int(r))
                               for r in self._detect[si].stragglers()]
        return Snapshot(t_s=self._now, stages=stages,
                        p95_ms=percentile(self._recent_ms, 95),
                        n_completed=self._done, stragglers=stragglers)

    def _tick(self) -> None:
        for ev in self.controller.step(self._snapshot()):
            if ev.kind == "replicas":
                self._set_alive(ev.stage, ev.new)
                self._start_batches(ev.stage)
            elif ev.kind == "batch":
                self.batch[ev.stage] = ev.new
                self._start_batches(ev.stage)
            elif ev.kind == "retire":
                self._retire_slot(ev.stage, ev.prev)
            # "knob" needs no state here: the level lives on the controller
            # and _knob_factor/_start_batches read it through self._level()
        if self._done < self._total:
            self._push(self._now + self.interval_s, "tick")

    # -- fault events --------------------------------------------------------

    def _apply_fault(self, ev) -> None:
        entry: Dict[str, object] = {"t_s": round(self._now, 9),
                                    "action": "inject", "kind": ev.kind,
                                    "stage": ev.stage}
        if ev.kind == "replica_kill":
            alive = self._alive_rids(ev.stage)
            if not alive or (len(alive) <= 1 and not self.faults.respawn):
                entry["replica"] = -1        # refused: pool would strand
            else:
                rid = alive[ev.replica % len(alive)]
                self._kill_slot(ev.stage, rid)
                entry["replica"] = rid
                if self.faults.respawn:
                    self._push(self._now + self.faults.respawn_delay_s,
                               "respawn", ev.stage)
        elif ev.kind == "replica_stall":
            alive = self._alive_rids(ev.stage)
            if not alive:
                entry["replica"] = -1
            else:
                rid = alive[ev.replica % len(alive)]
                self._slow[(ev.stage, rid)] = max(1.0, ev.factor)
                entry["replica"] = rid
                entry["factor"] = ev.factor
                if ev.duration_s > 0:
                    self._push(self._now + ev.duration_s, "unstall",
                               (ev.stage, rid))
        else:                                # writer_stall
            self._wstall_until = self._now + ev.duration_s
            entry["duration_s"] = ev.duration_s
            self._push(self._wstall_until, "wresume", None)
        self.fault_log.append(entry)

    # -- run -----------------------------------------------------------------

    def run(self) -> SimResult:
        for i, (req, t) in enumerate(zip(self.requests, self.arrivals)):
            self._push(t, "arr", (i, req))
        self._total = min(len(self.requests), len(self.arrivals))
        if self.controller is not None and self._total:
            self._push(self.interval_s, "tick")
        if self._total:
            for fev in self.faults.events:
                self._push(fev.t_s, "fault", fev)
        t_first = self.arrivals[0] if self._total else 0.0
        t_last_done = t_first

        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            self._advance(t)
            if kind == "arr":
                i, req = payload
                if req.op == "query":
                    q = SimQuery(stream_idx=i, t_arrive=t, t_enq=t)
                    self._pending[STAGE_NAMES[0]].append(q)
                    self._depth_max[STAGE_NAMES[0]] = max(
                        self._depth_max[STAGE_NAMES[0]],
                        len(self._pending[STAGE_NAMES[0]]))
                    self._start_batches(STAGE_NAMES[0])
                else:
                    self._wq.append((t, req))
                    self._start_writes()
            elif kind == "done":
                stage, rid = payload
                if (stage, rid) in self._doomed:
                    # the slot died mid-batch; its items already requeued
                    self._doomed.discard((stage, rid))
                    self._busy_items.pop((stage, rid), None)
                    continue
                items = self._busy_items.pop((stage, rid))
                if self._shrink_pend[stage] > 0:
                    # scale-down finished its last batch: slot retires
                    self._shrink_pend[stage] -= 1
                    self._slow.pop((stage, rid), None)
                else:
                    self._free[stage].append(rid)
                    self._free[stage].sort()
                si = STAGE_NAMES.index(stage)
                if si + 1 < len(STAGE_NAMES):
                    nxt = STAGE_NAMES[si + 1]
                    for it in items:
                        it.t_enq = t
                    self._pending[nxt].extend(items)
                    self._depth_max[nxt] = max(self._depth_max[nxt],
                                               len(self._pending[nxt]))
                    self._start_batches(nxt)
                else:
                    tr = self.tracer
                    for it in items:
                        it.t_done = t
                        if tr is not None:
                            tr.add_span("request", it.t_arrive, t,
                                        cat="request", tid="request/query",
                                        req=it.stream_idx, op="query", ok=True)
                        self.queries.append(it)
                        self._done += 1
                        self._recent_ms.append(it.latency_s * 1e3)
                        if len(self._recent_ms) > self._recent_cap:
                            del self._recent_ms[:-self._recent_cap]
                    t_last_done = max(t_last_done, t)
                self._start_batches(stage)
            elif kind == "wdone":
                for t_arr, _req in payload:
                    self.mutation_latencies.append(t - t_arr)
                    self._done += 1
                t_last_done = max(t_last_done, t)
                self._writer_busy = False
                self._start_writes()
            elif kind == "fault":
                self._apply_fault(payload)
            elif kind == "respawn":
                rid = self._spawn_slot(payload)
                self.fault_log.append({"t_s": round(t, 9),
                                       "action": "respawn", "kind":
                                       "replica_kill", "stage": payload,
                                       "replica": rid})
                self._start_batches(payload)
            elif kind == "unstall":
                stage, rid = payload
                if self._slow.pop((stage, rid), None) is not None:
                    self.fault_log.append({"t_s": round(t, 9),
                                           "action": "unstall",
                                           "kind": "replica_stall",
                                           "stage": stage, "replica": rid})
            elif kind == "wresume":
                self._start_writes()
            else:                                    # tick
                self._tick()

        assert self._done == self._total, \
            f"sim lost items: {self._done} != {self._total}"
        rows = []
        for s in STAGE_NAMES:
            busy, idle = self._busy[s], max(self._cap[s] - self._busy[s], 0.0)
            rows.append({
                "stage": s, "busy_s": busy, "idle_s": idle, "stall_s": 0.0,
                "occupancy": busy / (busy + idle) if busy + idle > 0 else 0.0,
                "batches": float(self._n_batches[s]),
                "n_items": float(self._n_items[s]),
                "queue_depth_max": float(self._depth_max[s]),
                "replicas": float(self.replicas[s]),
                "mean_batch": (self._n_items[s] / self._n_batches[s]
                               if self._n_batches[s] else 0.0)})
        return SimResult(queries=sorted(self.queries,
                                        key=lambda q: q.stream_idx),
                         mutation_latencies_s=list(self.mutation_latencies),
                         controller=self.controller,
                         wall_s=max(t_last_done - t_first, 1e-9),
                         stage_rows=rows,
                         write_batches=list(self.write_batches),
                         failed=sorted(self.failed,
                                       key=lambda q: q.stream_idx),
                         fault_log=list(self.fault_log),
                         n_retried=self.n_retried)
