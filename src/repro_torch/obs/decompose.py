"""Critical-path decomposition: where did each request's latency go?

Per request, end-to-end latency splits into per-stage *service shares*
(each batch's service time divided across its members — exactly what
``Stage.run`` / the simulator's cost model attribute) plus a residual
**queue** component (end-to-end minus the sum of service shares: time
spent waiting in stage queues, coalescing buffers, or the batcher).

``decomposition_summary`` reduces a request population to the per-component
p50/p95 table of ``ScenarioReport.trace_decomposition`` — RAGO-style stage
attribution as a regression-gated number.
"""
# analysis: deterministic -- pure attribution math over recorded traces
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.serving.accounting import percentile

# canonical stage order of the query path (matches QUERY_STAGE_NAMES)
STAGE_ORDER = ("query_embed", "retrieval", "rerank", "generation")


def request_components(latency_s: float, stages: Dict[str, float],
                       order: Sequence[str] = STAGE_ORDER
                       ) -> Dict[str, float]:
    """One request's latency split: queue + per-stage service shares (s).

    The queue share is the residual ``latency - sum(service shares)``
    clamped at zero (measurement jitter on the live path can leave the sum
    a hair above end-to-end)."""
    out = {s: float(stages.get(s, 0.0)) for s in order}
    out["queue"] = max(float(latency_s) - sum(out.values()), 0.0)
    return out


def decomposition_summary(rows: Iterable[Tuple[float, Dict[str, float]]],
                          order: Sequence[str] = STAGE_ORDER
                          ) -> Dict[str, Dict[str, float]]:
    """Per-component p50/p95 (ms) over ``(latency_s, stage_shares)`` rows.

    Returns ``{component: {"p50_ms": ..., "p95_ms": ...}}`` for ``queue``
    plus every stage in ``order`` — the ``trace_decomposition`` block."""
    comps: Dict[str, List[float]] = {"queue": []}
    for s in order:
        comps[s] = []
    n = 0
    for latency_s, stages in rows:
        split = request_components(latency_s, stages, order)
        for name, val in split.items():
            comps[name].append(val * 1e3)
        n += 1
    out: Dict[str, Dict[str, float]] = {}
    for name in ("queue",) + tuple(order):
        xs = comps[name]
        out[name] = {"p50_ms": percentile(xs, 50) if n else 0.0,
                     "p95_ms": percentile(xs, 95) if n else 0.0}
    return out
