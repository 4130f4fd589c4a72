"""Fault tolerance and elasticity: the port of
``repro.distributed.fault_tolerance``.

  * ``HeartbeatTracker`` — every worker stamps (host_id, step, t) after each
    step; the coordinator's view is a local dict or a directory of stamp
    files (the mechanism is transport-agnostic).
  * ``StragglerDetector`` — per-member duration quantiles; a member whose
    median exceeds ``quantile × tolerance`` is flagged.  The elastic
    executor and the scenario simulator key it by replica id.
  * ``ElasticPlan`` / ``plan_elastic_mesh`` — given the surviving device
    count, the largest (data, model) mesh (or (pod, data, model)) that
    keeps the tensor-parallel degree; training restarts on it from the
    latest checkpoint (arrays are keyed by name, so any mesh can load
    them).
  * ``FaultTolerantRunner`` — heartbeats, straggler records and periodic
    asynchronous checkpoints around a step function; the data pipeline
    being a pure function of (seed, step), a restart from the latest
    checkpoint ends bit for bit where an uninterrupted run ends.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Heartbeat:
    host_id: int
    step: int
    t: float


class HeartbeatTracker:
    """Coordinator view of worker liveness.

    ``grace_s`` is the startup grace period for hosts that have never
    stamped: a freshly-launched fleet should not read as all-dead at t=0
    just because nobody has completed a step yet.  It defaults to
    ``timeout_s``, anchored at tracker construction.
    """

    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 directory: Optional[str] = None,
                 grace_s: Optional[float] = None):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.grace_s = timeout_s if grace_s is None else grace_s
        self.t_start = time.time()
        self.dir = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
        self.beats: Dict[int, Heartbeat] = {}

    def stamp(self, host_id: int, step: int, t: Optional[float] = None) -> None:
        t = time.time() if t is None else t
        hb = Heartbeat(host_id, step, t)
        self.beats[host_id] = hb
        if self.dir:
            path = os.path.join(self.dir, f"host_{host_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(hb.__dict__, f)
            os.replace(tmp, path)

    def refresh_from_disk(self) -> None:
        if not self.dir:
            return
        for name in os.listdir(self.dir):
            if name.startswith("host_") and name.endswith(".json"):
                try:
                    with open(os.path.join(self.dir, name)) as f:
                        d = json.load(f)
                    self.beats[d["host_id"]] = Heartbeat(**d)
                except (OSError, ValueError, KeyError):
                    continue

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        dead = []
        for h in range(self.n_hosts):
            hb = self.beats.get(h)
            if hb is None:
                # never stamped: dead only once the startup grace elapses
                if now - self.t_start > self.grace_s:
                    dead.append(h)
            elif now - hb.t > self.timeout_s:
                dead.append(h)
        return dead

    def alive(self, now: Optional[float] = None) -> int:
        return self.n_hosts - len(self.dead_hosts(now))


class StragglerDetector:
    """Quantile-based straggler flagging over per-host step durations.

    Keys are opaque hashables: training uses host ids, elastic serving uses
    per-replica ids within one stage pool.  ``min_samples`` guards against
    flagging off a single slow batch; ``forget`` drops a retired member's
    history so its replacement starts clean.
    """

    def __init__(self, window: int = 50, quantile: float = 0.5,
                 tolerance: float = 2.0, min_samples: int = 1):
        self.window = window
        self.quantile = quantile
        self.tolerance = tolerance
        self.min_samples = min_samples
        self.durations: Dict[object, List[float]] = {}

    def record(self, host_id, duration_s: float) -> None:
        xs = self.durations.setdefault(host_id, [])
        xs.append(duration_s)
        if len(xs) > self.window:
            xs.pop(0)

    def forget(self, host_id) -> None:
        self.durations.pop(host_id, None)

    def stragglers(self) -> List:
        if len(self.durations) < 2:
            return []
        medians = {h: float(np.median(xs))
                   for h, xs in self.durations.items()
                   if len(xs) >= self.min_samples}
        if len(medians) < 2:
            return []
        fleet = float(np.quantile(list(medians.values()), self.quantile))
        return [h for h, m in medians.items()
                if m > self.tolerance * fleet]


@dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    devices_used: int
    dropped: int


def plan_elastic_mesh(n_devices: int, model_parallel: int,
                      multi_pod_size: int = 0) -> ElasticPlan:
    """Largest (pod, data, model) mesh fitting n_devices.

    The tensor-parallel degree is kept (re-sharding it mid-run changes
    every operation's layout); data parallelism is the elastic axis."""
    assert n_devices >= model_parallel, (n_devices, model_parallel)
    if multi_pod_size and n_devices >= 2 * multi_pod_size:
        pods = n_devices // multi_pod_size
        data = multi_pod_size // model_parallel
        used = pods * data * model_parallel
        return ElasticPlan((pods, data, model_parallel),
                           ("pod", "data", "model"), used,
                           n_devices - used)
    data = n_devices // model_parallel
    used = data * model_parallel
    return ElasticPlan((data, model_parallel), ("data", "model"),
                       used, n_devices - used)


class FaultTolerantRunner:
    """Glue: heartbeat + straggler + checkpoint-restart around a step fn."""

    def __init__(self, ckpt_manager, heartbeats: HeartbeatTracker,
                 stragglers: StragglerDetector, host_id: int = 0,
                 ckpt_every: int = 100):
        self.ckpt = ckpt_manager
        self.hb = heartbeats
        self.sd = stragglers
        self.host_id = host_id
        self.ckpt_every = ckpt_every

    def run(self, state, step_fn, batch_iter, n_steps: int,
            start_step: int = 0):
        step = start_step
        metrics = None
        for batch in batch_iter:
            if step >= n_steps:
                break
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            self.hb.stamp(self.host_id, step)
            self.sd.record(self.host_id, dt)
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save(state, step)
        self.ckpt.save(state, step, blocking=True)
        return state, step, metrics
