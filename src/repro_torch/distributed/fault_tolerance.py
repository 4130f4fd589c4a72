"""Liveness and straggler tracking: the port of the two classes of
``repro.distributed.fault_tolerance`` that serving uses.

  * ``HeartbeatTracker`` — every worker stamps (host_id, step, t) after each
    step; the coordinator's view is a local dict or a directory of stamp
    files (the mechanism is transport-agnostic).
  * ``StragglerDetector`` — per-member duration quantiles; a member whose
    median exceeds ``quantile × tolerance`` is flagged.  The elastic
    executor and the scenario simulator key it by replica id.

The reference's elastic mesh plan and checkpoint-restart runner belong to
training (ROADMAP.md queue 1 item 11) and are not ported here.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

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
