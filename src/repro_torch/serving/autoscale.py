"""Occupancy-driven autoscaling + SLO-aware quality knobs (the control loop).

The ``AutoscaleController`` closes the loop from measurement (per-stage
busy/idle/stall occupancy, queue depths, tail latency) to control:

* **replica scaling** — grow the bottleneck stage's worker pool when it is
  saturated with backlog, shrink pools that idle (RAGO, arXiv 2503.14649:
  per-stage parallelism allocation is the dominant RAG serving lever);
* **batch scaling** — once a bottleneck pool is at ``max_replicas`` and
  still behind, widen its coalescing micro-batch (throughput for latency);
  relax batches back toward their configured base when pressure clears;
* **quality ladder** — when p95 latency breaches the SLO, step
  ``nprobe``/``rerank_k`` down a configured ladder (RAG-Stack,
  arXiv 2510.20296: retrieval knobs trade quality for latency along a
  measurable Pareto front), and step back up when headroom returns.

Determinism contract: ``step(snapshot)`` is a pure function of the
controller's config + prior snapshots — it never reads the wall clock or any
RNG, so a recorded snapshot sequence replays to an identical
``ScaleEvent`` stream (the reproducibility the benchmark timelines and the
seed-determinism tests rely on).  Wall-clock time only enters through
``sample()``/``start()``, which *build* snapshots from a live executor.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.spec import AutoscaleSpec
from repro_torch.serving.elastic import ElasticExecutor


def default_ladder(nprobe: int, rerank_k: int, max_new: int = 0  # deterministic
                   ) -> List[Tuple[int, ...]]:
    """Quality ladder from the configured knobs down to the cheapest step:
    halve ``nprobe`` first (retrieval cost is the steep axis), then
    ``rerank_k``, then — when the generation backend exposes the knob —
    ``max_new`` (decode length, floored at a quarter of the configured
    value: shorter answers, never no answer)."""
    nprobe, rerank_k = max(1, int(nprobe)), max(1, int(rerank_k))
    if max_new <= 0:
        steps: List[Tuple[int, ...]] = [(nprobe, rerank_k)]
        while steps[-1] != (1, 1):
            np_, rk = steps[-1]
            if np_ > 1:
                np_ = max(1, np_ // 2)
            else:
                rk = max(1, rk // 2)
            steps.append((np_, rk))
        return steps
    mn = max(1, int(max_new))
    mn_min = max(1, mn // 4)
    steps = [(nprobe, rerank_k, mn)]
    while steps[-1] != (1, 1, mn_min):
        np_, rk, m = steps[-1]
        if np_ > 1:
            np_ = max(1, np_ // 2)
        elif rk > 1:
            rk = max(1, rk // 2)
        else:
            m = max(mn_min, m // 2)
        steps.append((np_, rk, m))
    return steps


@dataclass
class ScaleEvent:
    """One control decision, as a typed event-stream entry."""

    t_s: float           # snapshot timestamp (run-relative seconds)
    kind: str            # replicas | batch | knob
    stage: str           # stage name; "" for pipeline-wide knob moves
    prev: int
    new: int
    reason: str

    def to_dict(self) -> Dict[str, object]:
        return {"t_s": self.t_s, "kind": self.kind, "stage": self.stage,
                "prev": self.prev, "new": self.new, "reason": self.reason}


@dataclass
class StageSample:
    """One stage's cumulative occupancy counters at a sampling instant."""

    name: str
    busy_s: float
    idle_s: float
    stall_s: float
    queue_depth: float
    replicas: int
    batch_size: int


@dataclass
class Snapshot:
    """Everything one controller step may look at.

    ``stragglers`` carries the executor's flagged (stage, rid) pairs inside
    the snapshot — not read live by ``step`` — so a recorded snapshot
    sequence still replays to an identical event stream (the determinism
    contract)."""

    t_s: float
    stages: List[StageSample]
    p95_ms: float = 0.0
    n_completed: int = 0
    stragglers: List[Tuple[str, int]] = field(default_factory=list)


@dataclass
class AutoscaleConfig:
    interval_s: float = 0.2
    max_replicas: int = 4
    min_replicas: int = 1
    max_batch: int = 64
    scale_up_occupancy: float = 0.75   # bottleneck busy share → grow
    scale_down_occupancy: float = 0.25  # idle share → shrink
    queue_high_per_replica: float = 4.0  # backlog/replica that means "behind"
    queue_low: float = 1.0
    slo_ms: float = 500.0
    knob_headroom: float = 0.5         # p95 below this slo share → step up
    cooldown_steps: int = 2            # controller steps between knob moves
    replica_cooldown_steps: int = 1
    # [(nprobe, rerank_k)] or [(nprobe, rerank_k, max_new)] per quality step
    ladder: List[Tuple[int, ...]] = field(default_factory=list)

    @classmethod
    def from_spec(cls, spec: AutoscaleSpec, base_nprobe: int = 0,
                  base_rerank_k: int = 0, base_max_new: int = 0
                  ) -> "AutoscaleConfig":
        """Map a declarative ``PipelineSpec.autoscale`` block onto the
        runtime config, deriving the default ladder from the pipeline's
        configured knobs when the spec leaves it empty."""
        ladder = [tuple(int(x) for x in step) for step in spec.ladder]
        if not ladder and (base_nprobe or base_rerank_k):
            ladder = default_ladder(base_nprobe or 1, base_rerank_k or 1,
                                    base_max_new)
        return cls(interval_s=spec.interval_ms / 1e3,
                   max_replicas=spec.max_replicas, slo_ms=spec.slo_ms,
                   max_batch=spec.max_batch, ladder=ladder)


class AutoscaleController:
    """Drive an ``ElasticExecutor`` from its own occupancy statistics.

    Pass ``executor=None`` to run the controller open-loop (pure decision
    replay over synthetic snapshots — the deterministic test mode); with an
    executor attached every decision is also *applied* (``set_replicas`` /
    ``set_batch_size`` / ``apply_knobs``).
    """

    def __init__(self, cfg: Optional[AutoscaleConfig] = None,
                 executor: Optional[ElasticExecutor] = None):
        cfg = cfg if cfg is not None else AutoscaleConfig()
        if executor is not None and not cfg.ladder:
            # derive the ladder without mutating the caller's config object
            cfg = dataclasses.replace(cfg, ladder=default_ladder(
                executor.knobs.get("nprobe", 1) or 1,
                executor.knobs.get("rerank_k", 1) or 1,
                executor.knobs.get("max_new", 0)))
        self.cfg = cfg
        self.executor = executor
        self.events: List[ScaleEvent] = []
        self.snapshots: List[Snapshot] = []   # every input step() has seen
        self.level = 0                     # current quality-ladder step
        self._prev: Optional[Snapshot] = None
        self._base_batch: Dict[str, int] = {}
        self._knob_wait = 0
        self._replica_wait: Dict[str, int] = {}
        self._retired: set = set()         # (stage, rid) already retired
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._t0: Optional[float] = None

    # -- live sampling ------------------------------------------------------

    def sample(self) -> Snapshot:
        """Build a snapshot from the attached executor (wall clock enters
        here and only here)."""
        assert self.executor is not None, "sample() needs an executor"
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        rows = self.executor.snapshot()
        stages = [StageSample(name=str(r["stage"]), busy_s=r["busy_s"],
                              idle_s=r["idle_s"], stall_s=r["stall_s"],
                              queue_depth=r["queue_depth"],
                              replicas=int(r["replicas"]),
                              batch_size=int(r["batch_size"]))
                  for r in rows]
        return Snapshot(t_s=now - self._t0, stages=stages,
                        p95_ms=self.executor.recent_p95_ms(),
                        n_completed=self.executor.n_completed,
                        stragglers=self.executor.straggler_rids())

    def start(self) -> "AutoscaleController":
        """Sample + step on a background thread at the configured cadence."""
        assert self.executor is not None, "start() needs an executor"
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.cfg.interval_s):
                if self.executor.aborted():
                    return
                self.step(self.sample())

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ragperf-autoscale")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- the control step ---------------------------------------------------

    def step(self, snap: Snapshot) -> List[ScaleEvent]:  # deterministic
        """One control decision round; returns (and records) the events."""
        self.snapshots.append(snap)
        prev, self._prev = self._prev, snap
        if not self._base_batch:
            self._base_batch = {s.name: s.batch_size for s in snap.stages}
        if prev is None:
            return []                      # need one full window first
        out: List[ScaleEvent] = []
        prev_by = {s.name: s for s in prev.stages}
        occ: Dict[str, float] = {}
        for s in snap.stages:
            p = prev_by.get(s.name)
            d_busy = s.busy_s - (p.busy_s if p else 0.0)
            d_idle = s.idle_s - (p.idle_s if p else 0.0)
            d_stall = s.stall_s - (p.stall_s if p else 0.0)
            total = d_busy + d_idle + d_stall
            occ[s.name] = d_busy / total if total > 0 else 0.0
        for name in list(self._replica_wait):
            if self._replica_wait[name] > 0:
                self._replica_wait[name] -= 1
        if self._knob_wait > 0:
            self._knob_wait -= 1

        out += self._retire_stragglers(snap)
        out += self._scale_replicas(snap, occ)
        out += self._scale_batches(snap, occ)
        out += self._walk_ladder(snap)
        self.events.extend(out)
        return out

    def _retire_stragglers(self, snap: Snapshot) -> List[ScaleEvent]:  # deterministic
        """Recovery action: a (stage, rid) flagged in the snapshot is
        retired — killed and replaced by a fresh replica — exactly once
        (``_retired`` is controller state, so replay reproduces it)."""
        out: List[ScaleEvent] = []
        for stage, rid in snap.stragglers:
            if (stage, rid) in self._retired:
                continue
            self._retired.add((stage, rid))
            out.append(ScaleEvent(
                snap.t_s, "retire", stage, rid, -1,
                f"straggler replica r{rid} flagged; retiring + respawn"))
            if self.executor is not None:
                self.executor.retire_replica(stage, rid)
        return out

    def _backlog(self, s: StageSample) -> float:  # deterministic
        return s.queue_depth / max(s.replicas, 1)

    def _scale_replicas(self, snap: Snapshot,  # deterministic
                        occ: Dict[str, float]) -> List[ScaleEvent]:
        cfg = self.cfg
        out: List[ScaleEvent] = []
        # bottleneck: deepest per-replica backlog, occupancy as tie-break
        ranked = sorted(snap.stages,
                        key=lambda s: (self._backlog(s), occ[s.name]),
                        reverse=True)
        btl = ranked[0]
        pressured = (self._backlog(btl) >= cfg.queue_high_per_replica
                     or (occ[btl.name] >= cfg.scale_up_occupancy
                         and btl.queue_depth >= btl.replicas))
        if pressured and btl.replicas < cfg.max_replicas \
                and self._replica_wait.get(btl.name, 0) == 0:
            new = btl.replicas + 1
            out.append(ScaleEvent(
                snap.t_s, "replicas", btl.name, btl.replicas, new,
                f"bottleneck backlog={self._backlog(btl):.1f} "
                f"occ={occ[btl.name]:.2f}"))
            # +1: the wait decrements at the top of each step, so N+1 blocks
            # exactly N subsequent steps
            self._replica_wait[btl.name] = cfg.replica_cooldown_steps + 1
            if self.executor is not None:
                self.executor.set_replicas(btl.name, new)
        # shrink at most one clearly-idle stage per step (stability)
        for s in snap.stages:
            if s.name == btl.name or s.replicas <= cfg.min_replicas:
                continue
            if occ[s.name] <= cfg.scale_down_occupancy \
                    and s.queue_depth <= cfg.queue_low \
                    and self._replica_wait.get(s.name, 0) == 0:
                new = s.replicas - 1
                out.append(ScaleEvent(
                    snap.t_s, "replicas", s.name, s.replicas, new,
                    f"idle occ={occ[s.name]:.2f} "
                    f"depth={s.queue_depth:.0f}"))
                self._replica_wait[s.name] = cfg.replica_cooldown_steps + 1
                if self.executor is not None:
                    self.executor.set_replicas(s.name, new)
                break
        return out

    def _scale_batches(self, snap: Snapshot,  # deterministic
                       occ: Dict[str, float]) -> List[ScaleEvent]:
        cfg = self.cfg
        out: List[ScaleEvent] = []
        for s in snap.stages:
            base = self._base_batch.get(s.name, s.batch_size)
            if s.replicas >= cfg.max_replicas \
                    and self._backlog(s) >= cfg.queue_high_per_replica \
                    and s.batch_size < cfg.max_batch:
                new = min(s.batch_size * 2, cfg.max_batch)
                out.append(ScaleEvent(
                    snap.t_s, "batch", s.name, s.batch_size, new,
                    f"pool maxed, backlog={self._backlog(s):.1f}"))
                if self.executor is not None:
                    self.executor.set_batch_size(s.name, new)
            elif s.batch_size > base and occ[s.name] <= cfg.scale_down_occupancy \
                    and s.queue_depth <= cfg.queue_low:
                new = max(base, s.batch_size // 2)
                out.append(ScaleEvent(
                    snap.t_s, "batch", s.name, s.batch_size, new,
                    f"pressure cleared, occ={occ[s.name]:.2f}"))
                if self.executor is not None:
                    self.executor.set_batch_size(s.name, new)
        return out

    def _walk_ladder(self, snap: Snapshot) -> List[ScaleEvent]:  # deterministic
        cfg = self.cfg
        if not cfg.ladder or self._knob_wait > 0 or snap.p95_ms <= 0.0:
            return []
        new_level = self.level
        if snap.p95_ms > cfg.slo_ms and self.level < len(cfg.ladder) - 1:
            new_level = self.level + 1
            why = f"p95={snap.p95_ms:.0f}ms > slo={cfg.slo_ms:.0f}ms"
        elif snap.p95_ms < cfg.knob_headroom * cfg.slo_ms and self.level > 0:
            new_level = self.level - 1
            why = f"p95={snap.p95_ms:.0f}ms < {cfg.knob_headroom:.0%} slo"
        if new_level == self.level:
            return []
        step = cfg.ladder[new_level]
        nprobe, rerank_k = step[0], step[1]
        max_new = step[2] if len(step) > 2 else None
        why += f" -> nprobe={nprobe} rerank_k={rerank_k}"
        if max_new is not None:
            why += f" max_new={max_new}"
        ev = ScaleEvent(snap.t_s, "knob", "", self.level, new_level, why)
        self.level = new_level
        self._knob_wait = cfg.cooldown_steps + 1
        if self.executor is not None:
            self.executor.apply_knobs(nprobe=nprobe, rerank_k=rerank_k,
                                      max_new=max_new)
        return [ev]

    # -- reporting ----------------------------------------------------------

    def replay_events(self) -> List[ScaleEvent]:  # deterministic
        """Re-run the recorded snapshot sequence through a *fresh*
        controller (no executor attached) and return its event stream.

        Because ``step`` is wall-clock-free, the replay must reproduce this
        controller's decisions exactly — the determinism check the
        benchmark and the seed-reproducibility tests assert on.
        """
        twin = AutoscaleController(dataclasses.replace(self.cfg))
        for snap in self.snapshots:
            twin.step(snap)
        return twin.events

    def event_dicts(self) -> List[Dict[str, object]]:  # deterministic
        return [e.to_dict() for e in self.events]

    def knob_timeline(self) -> List[Dict[str, object]]:  # deterministic
        """The quality-degradation timeline: (t, level, nprobe, rerank_k
        [, max_new])."""
        out = []
        for e in self.events:
            if e.kind != "knob":
                continue
            step = self.cfg.ladder[e.new]
            row = {"t_s": e.t_s, "level": e.new,
                   "nprobe": step[0], "rerank_k": step[1]}
            if len(step) > 2:
                row["max_new"] = step[2]
            out.append(row)
        return out
