"""Per-request latency accounting for the serving harness (the port of
``repro.serving.accounting``).

Every request carries its full lifecycle timeline — arrival (enqueue),
execution start (dequeue into a batch), completion — so queue wait and
service time are separable from end-to-end latency.  Stage-level time
(embed / retrieval / rerank / generation, via ``StageTimer`` deltas) is
attributed per request by dividing each batch's stage delta across its
members.

``summary()`` reports the serving metrics the paper's offline harness cannot
see: p50/p95/p99 latency, queue-wait share, achieved vs offered QPS, and
goodput under an SLO (completed queries whose end-to-end latency met the
deadline, per second of wall time).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile, q in [0,100].

    Matches ``numpy.percentile``'s default (``linear``) method; implemented
    here so the accountant has no hard numpy dependency on the hot path and
    the contract is pinned by tests rather than by numpy's default changing.
    """
    if not len(xs):
        return 0.0
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


@dataclass
class RequestRecord:
    req_id: int
    op: str                       # query | insert | update | removal
    arrival_s: float              # offsets on the run's perf_counter clock
    start_s: float = 0.0
    end_s: float = 0.0
    batch_size: int = 1
    ok: bool = True
    stages: Dict[str, float] = field(default_factory=dict)

    @property
    def queue_wait_s(self) -> float:
        return self.start_s - self.arrival_s

    @property
    def service_s(self) -> float:
        return self.end_s - self.start_s

    @property
    def latency_s(self) -> float:
        return self.end_s - self.arrival_s


class LatencyAccountant:
    """Thread-safe collector of completed ``RequestRecord``s."""

    def __init__(self, slo_ms: Optional[float] = None):
        self.slo_ms = slo_ms
        self.records: List[RequestRecord] = []   # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, rec: RequestRecord) -> None:
        with self._lock:
            self.records.append(rec)

    def _by_op(self, op: str) -> List[RequestRecord]:
        with self._lock:
            recs = list(self.records)
        return [r for r in recs if r.op == op and r.ok]

    def latencies_ms(self, op: str = "query") -> List[float]:
        return [r.latency_s * 1e3 for r in self._by_op(op)]

    def summary(self, offered_qps: Optional[float] = None) -> Dict[str, float]:
        with self._lock:
            recs = list(self.records)
        done = [r for r in recs if r.ok]
        queries = [r for r in done if r.op == "query"]
        failed = [r for r in recs if not r.ok]
        out: Dict[str, float] = {
            "n_requests": float(len(done)),
            "n_queries": float(len(queries)),
            "n_failed": float(len(failed)),
            # every record is terminal (completed or explicitly failed);
            # availability is the completed share of that total
            "error_rate": len(failed) / len(recs) if recs else 0.0,
            "availability": len(done) / len(recs) if recs else 1.0,
        }
        if not done:
            return out
        t0 = min(r.arrival_s for r in done)
        t1 = max(r.end_s for r in done)
        wall = max(t1 - t0, 1e-9)
        out["wall_s"] = wall
        out["achieved_qps"] = len(queries) / wall
        if offered_qps is not None:
            out["offered_qps"] = offered_qps
        lat = [r.latency_s * 1e3 for r in queries]
        wait = [r.queue_wait_s * 1e3 for r in queries]
        svc = [r.service_s * 1e3 for r in queries]
        for name, xs in (("latency_ms", lat), ("queue_wait_ms", wait),
                         ("service_ms", svc)):
            if not xs:
                continue
            out[f"p50_{name}"] = percentile(xs, 50)
            out[f"p95_{name}"] = percentile(xs, 95)
            out[f"p99_{name}"] = percentile(xs, 99)
            out[f"mean_{name}"] = sum(xs) / len(xs)
        if self.slo_ms is not None and queries:
            good = [r for r in queries if r.latency_s * 1e3 <= self.slo_ms]
            out["slo_ms"] = float(self.slo_ms)
            out["slo_attainment"] = len(good) / len(queries)
            out["goodput_qps"] = len(good) / wall
        # mutation-op tail (contention with the read path)
        muts = [r for r in done if r.op != "query"]
        if muts:
            mlat = [r.latency_s * 1e3 for r in muts]
            out["n_mutations"] = float(len(muts))
            out["p95_mutation_latency_ms"] = percentile(mlat, 95)
        return out
