"""Low-overhead resource monitor (paper §3.4, §5.8): the port of
``repro.monitor.monitor``.

Design mirrors the paper:
  * decoupled, low-priority background daemon thread — the RAG pipeline never
    calls the probes on its critical path;
  * fixed-size circular buffer per metric (default 2 MB equivalent) so memory
    stays bounded on long runs;
  * the monitor measures its own probe cost and *adapts the sampling period*
    (backs off when probes get expensive);
  * graceful shutdown: buffered samples are flushed to disk on stop(),
    atexit, or crash (``flush_on_crash`` installs an excepthook).

Probes (NVML/GPM probes from the paper become host probes + PyTorch's
device-memory accounting):
  * /proc/self/statm       — host RSS;
  * /proc/stat             — system CPU utilization;
  * /proc/self/io          — read/write bytes (I/O throughput);
  * torch.cuda.memory_allocated — device memory held by PyTorch tensors;
  * user callbacks         — e.g. ``db.stats()`` gauges.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

# -- gauge naming schema ------------------------------------------------------
#
# Every monitor time-series belongs to a documented family so downstream
# consumers (MetricsRegistry.absorb_monitor, dashboards, the trace exporter)
# can route and aggregate by prefix instead of guessing.  ``add_gauge``
# warns (DeprecationWarning) on names outside the schema; ad-hoc keys still
# record, but they are on notice.
GAUGE_SCHEMA: Dict[str, str] = {
    # exact names: the host probes _sample_once pushes every period
    "host_rss_bytes": "process resident set size (bytes)",
    "cpu_util": "system-wide CPU utilization fraction over the period",
    "io_read_Bps": "process read throughput (bytes/s) over the period",
    "io_write_Bps": "process write throughput (bytes/s) over the period",
    "torch_device_bytes": "bytes of device memory held by PyTorch tensors",
    # prefix families (trailing underscore = prefix match)
    "db_": "vector-DB gauges: db_live, db_shards, db_shard_imbalance, ...",
    "serving_": "harness gauges: serving_queue_depth / _in_flight / ...",
    "stage_": "staged-executor gauges: stage_<name>_queue_depth",
    "elastic_": "elastic-executor gauges: elastic_<name>_queue_depth / "
                "_replicas, elastic_write_queue_depth, knob values",
    "gen_": "generation-engine stats mirrored onto the unified timeline",
}


def gauge_family(name: str) -> Optional[str]:
    """The schema family a gauge name belongs to (None = off-schema)."""
    if name in GAUGE_SCHEMA:
        return name
    for key in GAUGE_SCHEMA:
        if key.endswith("_") and name.startswith(key):
            return key
    return None


def gauges_schema() -> Dict[str, str]:
    """The documented gauge naming schema (family -> description)."""
    return dict(GAUGE_SCHEMA)


class RingBuffer:
    """Fixed-capacity (t, value) ring; oldest samples overwritten."""

    def __init__(self, capacity: int = 131072):   # 2 floats * 8B * 128Ki = 2 MB
        self.t = np.zeros(capacity, np.float64)
        self.v = np.zeros(capacity, np.float64)
        self.capacity = capacity
        self.n = 0                                # total pushed

    def push(self, t: float, v: float) -> None:
        i = self.n % self.capacity
        self.t[i] = t
        self.v[i] = v
        self.n += 1

    def values(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n <= self.capacity:
            return self.t[: self.n].copy(), self.v[: self.n].copy()
        i = self.n % self.capacity
        return (np.concatenate([self.t[i:], self.t[:i]]),
                np.concatenate([self.v[i:], self.v[:i]]))

    def summary(self) -> Dict[str, float]:
        _, v = self.values()
        if not len(v):
            return {"n": 0}
        return {"n": int(self.n), "mean": float(v.mean()),
                "max": float(v.max()), "min": float(v.min()),
                "last": float(v[-1])}


def _read_rss_bytes() -> float:
    try:
        with open("/proc/self/statm") as f:
            return float(f.read().split()[1]) * PAGE
    except OSError:
        return 0.0


def _read_cpu_times() -> Tuple[float, float]:
    """(busy, total) jiffies across all cpus."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        vals = [float(x) for x in parts]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)
        total = sum(vals)
        return total - idle, total
    except OSError:
        return 0.0, 1.0


def _read_io_bytes() -> Tuple[float, float]:
    try:
        out = {"read_bytes": 0.0, "write_bytes": 0.0}
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in out:
                    out[k] = float(v)
        return out["read_bytes"], out["write_bytes"]
    except OSError:
        return 0.0, 0.0


def _device_bytes() -> float:
    """Device memory held by PyTorch tensors (0 without a card)."""
    if not torch.cuda.is_available():
        return 0.0
    return float(torch.cuda.memory_allocated())


@dataclass
class MonitorConfig:
    interval_s: float = 0.1
    ring_capacity: int = 131072
    out_path: str = ""
    adaptive: bool = True
    max_probe_fraction: float = 0.05   # probes may use ≤5% of wall time
    max_backoff: float = 10.0          # adaptive interval ≤ this × interval_s
    flush_on_crash: bool = True


class ResourceMonitor:
    """Background sampling daemon with bounded buffers and graceful flush."""

    def __init__(self, cfg: MonitorConfig = MonitorConfig()):
        self.cfg = cfg
        self.buffers: Dict[str, RingBuffer] = {}
        self.callbacks: Dict[str, Callable[[], float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._interval = cfg.interval_s
        self.probe_cost_s = 0.0
        self._prev_cpu = _read_cpu_times()
        self._prev_io = _read_io_bytes()
        self._prev_io_t = time.perf_counter()
        self._flushed = False
        self._hooks = None   # (ours, the previous) sys.excepthook while started

    def add_gauge(self, name: str, fn: Callable[[], float]) -> None:
        if gauge_family(name) is None:
            warnings.warn(
                f"gauge {name!r} is outside the documented naming schema "
                f"(see repro_torch.monitor.monitor.gauges_schema()); ad-hoc keys are "
                f"deprecated — use a family prefix "
                f"({', '.join(k for k in GAUGE_SCHEMA if k.endswith('_'))})",
                DeprecationWarning, stacklevel=2)
        self.callbacks[name] = fn

    def add_gauges(self, gauges: Dict[str, Callable[[], float]]) -> None:
        """Register a family of gauges at once (e.g. the serving harness's
        queue-depth / in-flight / batch-size probes)."""
        for name, fn in gauges.items():
            self.add_gauge(name, fn)

    def _buf(self, name: str) -> RingBuffer:
        if name not in self.buffers:
            self.buffers[name] = RingBuffer(self.cfg.ring_capacity)
        return self.buffers[name]

    def _sample_once(self) -> None:
        t0 = time.perf_counter()
        self._buf("host_rss_bytes").push(t0, _read_rss_bytes())
        busy, total = _read_cpu_times()
        pb, pt = self._prev_cpu
        if total > pt:
            self._buf("cpu_util").push(t0, (busy - pb) / (total - pt))
        self._prev_cpu = (busy, total)
        rb, wb = _read_io_bytes()
        prb, pwb = self._prev_io
        dt = max(t0 - self._prev_io_t, 1e-9)
        self._buf("io_read_Bps").push(t0, (rb - prb) / dt)
        self._buf("io_write_Bps").push(t0, (wb - pwb) / dt)
        self._prev_io, self._prev_io_t = (rb, wb), t0
        self._buf("torch_device_bytes").push(t0, _device_bytes())
        for name, fn in list(self.callbacks.items()):
            self._buf(name).push(t0, float(fn()))
        cost = time.perf_counter() - t0
        self.probe_cost_s += cost
        if self.cfg.adaptive:
            # keep probe time under max_probe_fraction of wall time, but
            # bound the backoff: one pathological probe (e.g. a gauge that
            # takes the DB lock mid index build) must not blind the monitor for
            # the rest of the run — the period recovers at the next sample
            floor = cost / self.cfg.max_probe_fraction
            self._interval = min(max(self.cfg.interval_s, floor),
                                 self.cfg.interval_s * self.cfg.max_backoff)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._sample_once()

    def start(self) -> "ResourceMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ragperf-monitor")
        self._thread.start()
        atexit.register(self.stop)
        if self.cfg.flush_on_crash:
            prev_hook = sys.excepthook

            def hook(tp, val, tb):
                self.stop()
                prev_hook(tp, val, tb)

            sys.excepthook = hook
            self._hooks = (hook, prev_hook)
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        # drop the process-wide references start() made, so a stopped
        # monitor (and whatever its gauges capture: a pipeline, a model on
        # the card) can be freed by a process that serves again
        atexit.unregister(self.stop)
        if self._hooks is not None and sys.excepthook is self._hooks[0]:
            sys.excepthook = self._hooks[1]
        self._hooks = None
        if self.cfg.out_path and not self._flushed:
            self.flush(self.cfg.out_path)

    def flush(self, path: str) -> None:
        """Persist all buffers as JSON time-series traces."""
        data = {}
        for name, buf in self.buffers.items():
            t, v = buf.values()
            data[name] = {"t": t.tolist(), "v": v.tolist(),
                          "summary": buf.summary()}
        data["_probe_cost_s"] = self.probe_cost_s
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(data, f)
        self._flushed = True

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: b.summary() for k, b in self.buffers.items()}


class StageTimer:
    """Per-stage wall-clock accumulation (the component-level profile).

    Accumulation is lock-protected: with replicated stage workers
    (``ElasticExecutor``) several threads time the same stage name
    concurrently, and the read-modify-write on ``totals`` must not lose
    updates.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}        # guarded-by: _lock
        self.counts: Dict[str, int] = {}          # guarded-by: _lock
        self.series: Dict[str, List[float]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            t = self.timer
            with t._lock:
                t.totals[self.name] = t.totals.get(self.name, 0.0) + dt
                t.counts[self.name] = t.counts.get(self.name, 0) + 1
                t.series.setdefault(self.name, []).append(dt)
            return False

    def stage(self, name: str) -> "_Ctx":
        return self._Ctx(self, name)

    def breakdown(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def mean(self, name: str) -> float:
        with self._lock:
            return (self.totals.get(name, 0.0)
                    / max(self.counts.get(name, 0), 1))
