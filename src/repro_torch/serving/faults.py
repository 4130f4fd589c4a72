"""Deterministic fault injection for elastic serving (the chaos layer).

A ``FaultSpec`` declares typed fault events at run-relative times:

* ``replica_kill``  — one replica of a stage pool dies; its in-flight batch
  is requeued (bounded by the retry budget) and, when ``respawn`` is on, a
  fresh replica is spawned ``respawn_delay_s`` later;
* ``replica_stall`` — a replica turns slow-straggler: its service time is
  multiplied by ``factor`` for ``duration_s`` (0 = until retired).  With
  ``detect`` enabled, per-replica service-time tracking feeds a
  ``StragglerDetector`` (adapted from ``distributed.fault_tolerance``) and
  the ``AutoscaleController`` retires the flagged replica and re-grows the
  pool;
* ``writer_stall``  — the serialized mutation writer freezes for
  ``duration_s``; pending mutations back up, then drain on resume.

The same ``FaultSpec`` drives both execution modes: ``ScenarioSim`` models
the events in virtual time (a bit-deterministic recovery timeline), and
``FaultInjector`` replays them wall-clock against a live
``ElasticExecutor`` (statistically reproducible, like every live run).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

FAULT_KINDS = ("replica_kill", "replica_stall", "writer_stall")


@dataclass
class FaultEvent:  # deterministic
    """One scheduled fault: what breaks, where, when, and how badly."""

    t_s: float                      # run-relative injection time
    kind: str                       # replica_kill | replica_stall | writer_stall
    stage: str = ""                 # target stage (replica faults)
    replica: int = 0                # index into the stage's alive replicas
    factor: float = 4.0             # service-time multiplier (replica_stall)
    duration_s: float = 0.0         # stall length; 0 = permanent

    _KEYS = ("t_s", "kind", "stage", "replica", "factor", "duration_s")

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, \
            f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}"
        assert self.t_s >= 0.0 and self.factor >= 1.0 and self.duration_s >= 0.0
        if self.kind != "writer_stall":
            assert self.stage, f"{self.kind} needs a target stage"

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._KEYS}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultEvent":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown FaultEvent keys: {sorted(unknown)}")
        kw = dict(d)
        kw["t_s"] = float(kw.get("t_s", 0.0))
        return cls(**kw)


@dataclass
class FaultSpec:  # deterministic
    """The chaos block: scheduled events + the recovery policy knobs."""

    events: List[FaultEvent] = field(default_factory=list)
    max_retries: int = 2            # requeue budget per request on failure
    respawn: bool = True            # auto-respawn killed replicas
    respawn_delay_s: float = 0.25
    detect: bool = False            # straggler detection -> controller retire
    straggler_tolerance: float = 2.0
    straggler_window: int = 16

    _KEYS = ("events", "max_retries", "respawn", "respawn_delay_s",
             "detect", "straggler_tolerance", "straggler_window")

    def __post_init__(self):
        assert self.max_retries >= 0 and self.respawn_delay_s >= 0.0
        assert self.straggler_tolerance > 1.0 and self.straggler_window >= 2

    @property
    def enabled(self) -> bool:
        return bool(self.events)

    def to_dict(self) -> Dict[str, Any]:
        return {"events": [e.to_dict() for e in self.events],
                "max_retries": self.max_retries, "respawn": self.respawn,
                "respawn_delay_s": self.respawn_delay_s,
                "detect": self.detect,
                "straggler_tolerance": self.straggler_tolerance,
                "straggler_window": self.straggler_window}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown FaultSpec keys: {sorted(unknown)}")
        kw: Dict[str, Any] = {}
        if "events" in d:
            kw["events"] = [FaultEvent.from_dict(e) for e in d["events"]]
        for k in ("max_retries", "straggler_window"):
            if k in d:
                kw[k] = int(d[k])
        for k in ("respawn_delay_s", "straggler_tolerance"):
            if k in d:
                kw[k] = float(d[k])
        for k in ("respawn", "detect"):
            if k in d:
                kw[k] = bool(d[k])
        return cls(**kw)


class FaultInjector:
    """Replay a ``FaultSpec`` wall-clock against a live ``ElasticExecutor``.

    Runs one background thread that sleeps to each event's (time-scaled)
    deadline and applies it through the executor's chaos surface
    (``kill_replica`` / ``set_replica_slow`` / ``stall_writer``); kills
    schedule their own respawn per the spec.  ``applied`` records what
    actually happened (with the injection wall offsets) for reports.
    """

    def __init__(self, executor, spec: FaultSpec, time_scale: float = 1.0):
        self.executor = executor
        self.spec = spec
        self.time_scale = time_scale
        self.applied: List[Dict[str, Any]] = []
        self._timeline: List[tuple] = []      # (t, kind, payload) to apply
        self._stop = threading.Event()
        self._thread: threading.Thread = None
        self._lock = threading.Lock()
        for ev in spec.events:
            self._timeline.append((ev.t_s * time_scale, "inject", ev))
            if ev.kind == "replica_kill" and spec.respawn:
                self._timeline.append(
                    ((ev.t_s + spec.respawn_delay_s) * time_scale,
                     "respawn", ev))
            elif ev.kind == "replica_stall" and ev.duration_s > 0:
                self._timeline.append(
                    ((ev.t_s + ev.duration_s) * time_scale, "unstall", ev))
        self._timeline.sort(key=lambda x: (x[0], x[1]))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FaultInjector":
        if self._thread is not None or not self._timeline:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ragperf-fault-injector")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- the injection loop --------------------------------------------------

    def _loop(self) -> None:
        t0 = time.perf_counter()
        # stalled replica ids by (stage, event id) so unstall hits the same
        # replica the stall did, even if the pool churned in between
        stalled: Dict[int, tuple] = {}
        for t_ev, action, ev in self._timeline:
            delay = (t0 + t_ev) - time.perf_counter()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set() or self.executor.aborted():
                return
            try:
                entry = {"t_s": time.perf_counter() - t0, "action": action,
                         "kind": ev.kind, "stage": ev.stage}
                if action == "inject" and ev.kind == "replica_kill":
                    # only take the pool's last replica when a respawn is
                    # coming, else the stage queue would strand
                    entry["replica"] = self.executor.kill_replica(
                        ev.stage, index=ev.replica,
                        allow_last=self.spec.respawn)
                elif action == "inject" and ev.kind == "replica_stall":
                    rid = self.executor.set_replica_slow(
                        ev.stage, ev.factor, index=ev.replica)
                    stalled[id(ev)] = (ev.stage, rid)
                    entry["replica"] = rid
                    entry["factor"] = ev.factor
                elif action == "inject":                 # writer_stall
                    self.executor.stall_writer(ev.duration_s
                                               * self.time_scale)
                    entry["duration_s"] = ev.duration_s
                elif action == "respawn":
                    entry["replica"] = self.executor.spawn_replica(ev.stage)
                elif action == "unstall":
                    stage, rid = stalled.pop(id(ev), (ev.stage, -1))
                    if rid >= 0:
                        self.executor.set_replica_slow(stage, 1.0, rid=rid)
                    entry["replica"] = rid
                with self._lock:
                    self.applied.append(entry)
            except Exception as e:               # noqa: BLE001
                # chaos must never crash the run it is testing: a failed
                # injection (e.g. stage already drained) is recorded, not
                # raised
                with self._lock:
                    self.applied.append({"action": action, "kind": ev.kind,
                                         "stage": ev.stage, "error": repr(e)})

    def applied_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.applied)
