"""Span-based tracer with explicit clock injection.

The tracer answers "where did request #417's 230 ms go?" by recording
half-open ``[t0, t1)`` spans — queue wait, batch coalescing, per-stage
service with replica id and retry index, shard fan-out/merge, writer
applies — plus zero-duration instant events (token milestones, requeues).

Clock injection is the determinism lever: live executors construct the
tracer over a ``WallClock`` (run-relative ``perf_counter``), while the
discrete-event simulator records spans at its own virtual timestamps via
``add_span``/``instant`` with explicit times — the same scenario seed
produces the bit-identical span list on every replay.

Overhead contract: instrumented code paths hold the tracer as an Optional
and skip *all* bookkeeping when it is ``None``; when present, recording is
one plain list append — atomic under CPython's GIL, so the hot path takes
no lock and replica workers never convoy on the tracer at batch
boundaries.
"""
from __future__ import annotations


import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class WallClock:
    """Run-relative wall clock: ``now()`` is seconds since construction
    (or the injected anchor), on the ``perf_counter`` timebase every
    executor already stamps with."""

    def __init__(self, anchor: Optional[float] = None):
        self.anchor = time.perf_counter() if anchor is None else float(anchor)

    def now(self) -> float:
        return time.perf_counter() - self.anchor


class VirtualClock:  # deterministic
    """Externally-driven clock for the deterministic simulator."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def set(self, t: float) -> None:
        self._t = float(t)

    def now(self) -> float:
        return self._t


@dataclass
class Span:
    """One half-open ``[t0, t1)`` interval on the trace timeline.

    ``tid`` is the logical track (``"retrieval/r1"``, ``"writer"``, a stage
    name); ``req`` is the request id the span belongs to (-1 = none);
    ``args`` carries span-specific attributes (replica, attempt, batch n).
    """

    name: str
    t0: float
    t1: float
    cat: str = ""
    tid: str = ""
    req: int = -1
    args: Dict[str, object] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass
class Instant:
    """A zero-duration event (first token, requeue, retirement)."""

    name: str
    t: float
    cat: str = ""
    tid: str = ""
    req: int = -1
    args: Dict[str, object] = field(default_factory=dict)


class Tracer:
    """Thread-safe span/instant recorder over an injected clock.

    ``enabled=False`` turns every record call into a no-op (the cheap path
    when a tracer must be threaded through but not collected); callers that
    can hold ``Optional[Tracer]`` should prefer ``None`` — that skips even
    the timestamp reads.
    """

    def __init__(self, clock=None, enabled: bool = True):
        self.clock = clock if clock is not None else WallClock()
        self.enabled = enabled
        # recording relies on CPython list.append atomicity (GIL) instead
        # of a lock: the hot path must never convoy concurrent stage
        # workers; readers snapshot via list() which is likewise atomic
        self._spans: List[Span] = []
        self._instants: List[Instant] = []

    def now(self) -> float:
        return self.clock.now()

    # -- recording ----------------------------------------------------------

    def add_span(self, name: str, t0: float, t1: float, cat: str = "",
                 tid: str = "", req: int = -1, **args) -> None:
        """Record a span at explicit timestamps (the simulator's API; live
        call sites derive ``t0 = now() - elapsed`` from their own timing)."""
        if not self.enabled:
            return
        self._spans.append(Span(name=name, t0=t0, t1=t1, cat=cat,
                                tid=tid or name, req=req, args=args))

    def instant(self, name: str, t: Optional[float] = None, cat: str = "",
                tid: str = "", req: int = -1, **args) -> None:
        if not self.enabled:
            return
        self._instants.append(
            Instant(name=name, t=self.clock.now() if t is None else t,
                    cat=cat, tid=tid or name, req=req, args=args))

    class _SpanCtx:
        def __init__(self, tracer: "Tracer", name: str, cat: str, tid: str,
                     req: int, args: Dict[str, object]):
            self.tracer, self.name, self.cat = tracer, name, cat
            self.tid, self.req, self.args = tid, req, args

        def __enter__(self):
            self.t0 = self.tracer.clock.now()
            return self

        def __exit__(self, *exc):
            self.tracer.add_span(self.name, self.t0, self.tracer.clock.now(),
                                 cat=self.cat, tid=self.tid, req=self.req,
                                 **self.args)
            return False

    def span(self, name: str, cat: str = "", tid: str = "",
             req: int = -1, **args) -> "Tracer._SpanCtx":
        """Context manager timing a block on the tracer's clock."""
        return Tracer._SpanCtx(self, name, cat, tid, req, args)

    # -- access -------------------------------------------------------------

    def spans(self) -> List[Span]:
        return list(self._spans)

    def instants(self) -> List[Instant]:
        return list(self._instants)

    def clear(self) -> None:
        self._spans = []
        self._instants = []

    def __len__(self) -> int:
        return len(self._spans) + len(self._instants)


def attach_pipeline(tracer: Optional[Tracer], pipeline) -> None:
    """Wire a tracer into a lock-step pipeline: every ``Stage.run`` emits a
    per-batch service span.  The staged/elastic executors do NOT use this —
    they emit richer per-item spans (queue wait, replica id, retry index)
    themselves, and attaching both would double-record service time."""
    pipeline.tracer = tracer
    for st in pipeline.stages:
        st.tracer = tracer
