"""MetricsRegistry: counters/gauges/histograms on one timeline.

Before this layer the run's telemetry was fragmented: ``ResourceMonitor``
ring buffers, ``StageStats`` rows, ``GenStats`` summaries, and the
controller's ``ScaleEvent`` stream each lived on their own clock and
schema.  The registry absorbs all of them as ``MetricPoint``s on a single
timeline (the tracer's clock), so a controller decision lands next to the
request spans it caused and one exporter renders everything.
"""
# analysis: deterministic -- timestamps come only from the injected clock
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.serving.accounting import percentile

KINDS = ("counter", "gauge", "event")


@dataclass
class MetricPoint:
    """One sample on the unified timeline."""

    t: float
    name: str
    value: float
    kind: str = "gauge"                  # counter | gauge | event
    args: Dict[str, object] = field(default_factory=dict)


class MetricsRegistry:
    """Thread-safe collector of counters, gauges, histograms and events.

    * counters — monotone accumulators; each ``counter_add`` records the
      running total as a timeline point;
    * gauges   — instantaneous values (``gauge_set``);
    * histograms — value reservoirs summarized via ``histogram_summary``
      (p50/p95/p99/mean), off the timeline;
    * events   — annotated instants (autoscale decisions, faults).
    """

    def __init__(self, clock=None):
        self.clock = clock
        self._points: List[MetricPoint] = []      # guarded-by: _lock
        self._counters: Dict[str, float] = {}     # guarded-by: _lock
        self._hist: Dict[str, List[float]] = {}   # guarded-by: _lock
        self._lock = threading.Lock()

    def _now(self, t: Optional[float]) -> float:
        if t is not None:
            return float(t)
        return self.clock.now() if self.clock is not None else 0.0

    # -- recording ----------------------------------------------------------

    def counter_add(self, name: str, delta: float = 1.0,
                    t: Optional[float] = None) -> float:
        with self._lock:
            total = self._counters.get(name, 0.0) + float(delta)
            self._counters[name] = total
            self._points.append(MetricPoint(self._now(t), name, total,
                                            kind="counter"))
        return total

    def gauge_set(self, name: str, value: float,
                  t: Optional[float] = None) -> None:
        with self._lock:
            self._points.append(MetricPoint(self._now(t), name,
                                            float(value), kind="gauge"))

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hist.setdefault(name, []).append(float(value))

    def event(self, name: str, t: Optional[float] = None, **args) -> None:
        with self._lock:
            self._points.append(MetricPoint(self._now(t), name, 1.0,
                                            kind="event", args=args))

    # -- absorption (the unification surface) -------------------------------

    def absorb_monitor(self, monitor) -> None:
        """Copy a ``ResourceMonitor``'s ring buffers onto the timeline.

        Monitor samples are stamped on the raw ``perf_counter`` timebase; a
        ``WallClock``-backed registry rebases them onto run-relative time."""
        anchor = getattr(self.clock, "anchor", 0.0) or 0.0
        for name, buf in monitor.buffers.items():
            ts, vs = buf.values()
            with self._lock:
                for t, v in zip(ts, vs):
                    self._points.append(MetricPoint(float(t) - anchor, name,
                                                    float(v), kind="gauge"))

    def absorb_stage_rows(self, rows, t: Optional[float] = None) -> None:
        """One ``StageStats.row()`` set (or sim stage rows) as gauges."""
        for row in rows:
            stage = row.get("stage", "stage")
            for key, val in row.items():
                if key == "stage":
                    continue
                self.gauge_set(f"stage_{stage}_{key}", float(val), t=t)

    def absorb_gen_stats(self, summary: Dict[str, float],
                         t: Optional[float] = None) -> None:
        for key, val in summary.items():
            self.gauge_set(f"gen_{key}", float(val), t=t)

    def absorb_scale_events(self, events) -> None:
        """``ScaleEvent``s (objects or ``to_dict`` rows) as timeline events,
        so controller decisions line up against the spans they caused."""
        for ev in events:
            d = ev if isinstance(ev, dict) else ev.to_dict()
            self.event(f"autoscale_{d.get('kind', 'event')}",
                       t=float(d.get("t_s", 0.0)),
                       **{k: v for k, v in d.items() if k != "t_s"})

    # -- access -------------------------------------------------------------

    def timeline(self) -> List[MetricPoint]:
        """Every point, time-ordered (stable for equal timestamps)."""
        with self._lock:
            pts = list(self._points)
        return sorted(pts, key=lambda p: p.t)

    def series(self, name: str) -> List[MetricPoint]:
        with self._lock:
            return [p for p in self._points if p.name == name]

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def histogram_summary(self, name: str) -> Dict[str, float]:
        with self._lock:
            xs = list(self._hist.get(name, []))
        if not xs:
            return {"n": 0.0}
        return {"n": float(len(xs)), "mean": sum(xs) / len(xs),
                "p50": percentile(xs, 50), "p95": percentile(xs, 95),
                "p99": percentile(xs, 99)}

    def histogram_names(self) -> List[str]:
        with self._lock:
            return sorted(self._hist)
