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

The process tracer (``PROCESS_TRACER``) records on ``EpochClock``, the
clock of ``torch.profiler``'s events, and code that holds no tracer of its
own records on it while a torch profiler session runs in the process
(``active_tracer``): an operator who profiles a live server gets the
program's spans on the profiler's timeline.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.autograd import profiler as _torch_profiler


class WallClock:
    """Run-relative wall clock: ``now()`` is seconds since construction
    (or the injected anchor), on the ``perf_counter`` timebase every
    executor already stamps with."""

    def __init__(self, anchor: Optional[float] = None):
        self.anchor = time.perf_counter() if anchor is None else float(anchor)

    def now(self) -> float:
        return time.perf_counter() - self.anchor


class EpochClock:
    """Seconds since the Unix epoch, from ``time.time_ns()``: the clock that
    ``torch.profiler``'s kineto events carry, so spans on it line up with
    the device's intervals in a profiler trace."""

    def now(self) -> float:
        return time.time_ns() / 1e9


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
    ``args`` carries span-specific attributes (replica, attempt, batch n);
    ``thread`` is the recording OS thread's id where the caller gave it (0
    = not recorded), which tells apart calls from several client threads
    on one track.
    """

    name: str
    t0: float
    t1: float
    cat: str = ""
    tid: str = ""
    req: int = -1
    args: Dict[str, object] = field(default_factory=dict)
    thread: int = 0

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


def _flat(args: Dict[str, object]) -> tuple:
    """``args`` as one flat tuple ``(key, value, key, value, ...)``."""
    out: list = []
    for kv in args.items():
        out += kv
    return tuple(out)


class Tracer:
    """Thread-safe span/instant recorder over an injected clock.

    Callers hold ``Optional[Tracer]`` and skip every timestamp read when it
    is ``None``. ``max_spans`` bounds the spans kept: beyond it the oldest
    are dropped (None: keep all).
    """

    def __init__(self, clock=None, max_spans: Optional[int] = None):
        self.clock = clock if clock is not None else WallClock()
        # recording relies on CPython append atomicity (GIL) instead of a
        # lock: the hot path must never convoy concurrent stage workers;
        # readers snapshot via list(), which is likewise atomic. A span is
        # kept as a plain tuple of ``Span``'s fields, its args flattened to
        # keys and values (``_flat``): the garbage collector stops tracking
        # a tuple of numbers and strings at its first pass over it, so a
        # long trace adds nothing to the work of every later collection (a
        # dict, an object or a nested tuple would stay tracked)
        self._spans = (collections.deque(maxlen=max_spans)
                       if max_spans is not None else [])
        self._instants: List[Instant] = []

    def now(self) -> float:
        return self.clock.now()

    # -- recording ----------------------------------------------------------

    def add_span(self, name: str, t0: float, t1: float, cat: str = "",
                 tid: str = "", req: int = -1, thread: int = 0,
                 **args) -> None:
        """Record a span at explicit timestamps (the simulator's API; live
        call sites derive ``t0 = now() - elapsed`` from their own timing)."""
        self._spans.append((name, t0, t1, cat, tid or name, req,
                            _flat(args), thread))

    def instant(self, name: str, t: Optional[float] = None, cat: str = "",
                tid: str = "", req: int = -1, **args) -> None:
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
        return [Span(n, t0, t1, cat, tid, req, dict(zip(a[::2], a[1::2])),
                     th)
                for n, t0, t1, cat, tid, req, a, th in list(self._spans)]

    def instants(self) -> List[Instant]:
        return list(self._instants)

    def __len__(self) -> int:
        return len(self._spans) + len(self._instants)


#: spans the process tracer keeps; older ones are dropped
PROCESS_MAX_SPANS = 1 << 18

#: the process-wide tracer on the profiler's clock (``active_tracer``)
PROCESS_TRACER = Tracer(clock=EpochClock(), max_spans=PROCESS_MAX_SPANS)


def active_tracer(explicit: Optional[Tracer]) -> Optional[Tracer]:
    """``explicit`` where it is set; otherwise ``PROCESS_TRACER`` while a
    torch profiler session runs in the process, else None.

    The session flag is the one torch's profiler sets on start and clears
    on stop, whatever its activities (a CUDA-only session too): one module
    attribute read, no lock."""
    if explicit is not None:
        return explicit
    return PROCESS_TRACER if _torch_profiler._is_profiler_enabled else None


_THREAD = threading.local()


def _native_id() -> int:
    """This OS thread's id, read once a thread (the read is a system call,
    several microseconds where system calls are slow)."""
    try:
        return _THREAD.id
    except AttributeError:
        _THREAD.id = threading.get_native_id()
        return _THREAD.id


class Phases:
    """The spans of one traced call, on lane ``tid``, sharing ``req`` and
    the calling OS thread's id.

    ``lap(name, *args)`` records the phase from the previous lap (or
    ``mark()``, or the call's start) to now, so consecutive phases cost one
    clock read each; ``close(name, *args)`` records the call's own span from
    its start, ``extra`` appended to its args. Args are flat ``key, value``
    pairs (``lap("db.main", "op", "ivf_topk")``): a lap builds no dict and
    no object the garbage collector keeps tracking. A phase's self time is
    its duration minus its children's (``self_times``)."""

    __slots__ = ("now", "append", "req", "tid", "thread", "t0", "t",
                 "extra")

    def __init__(self, tracer: Tracer, req: int, tid: str = "db"):
        self.now, self.append = tracer.clock.now, tracer._spans.append
        self.req, self.tid = req, tid
        self.thread = _native_id()
        self.extra: tuple = ()
        self.t0 = self.t = self.now()

    def mark(self) -> None:
        """Start the next phase here: what ran since the last lap belongs
        to no phase (it stays in the call's self time)."""
        self.t = self.now()

    def elapsed_ms(self) -> float:
        """Milliseconds since the last lap or mark."""
        return (self.now() - self.t) * 1e3

    def lap(self, name: str, *args) -> None:
        t = self.now()
        self.append((name, self.t, t, "db", self.tid, self.req, args,
                     self.thread))
        self.t = t

    def close(self, name: str, *args) -> None:
        self.append((name, self.t0, self.now(), "db", self.tid, self.req,
                     args + self.extra, self.thread))


def self_times(spans: List[Span]) -> List[float]:
    """Each span's duration less the part its direct children cover: a
    child is a span of the same OS thread and track whose interval lies
    inside it, the innermost such container being its parent."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].thread, spans[i].tid,
                                  spans[i].t0, -spans[i].t1))
    out = [s.dur for s in spans]
    stack: List[int] = []
    for i in order:
        s = spans[i]
        while stack and not (
                spans[stack[-1]].thread == s.thread
                and spans[stack[-1]].tid == s.tid
                and s.t0 >= spans[stack[-1]].t0
                and s.t1 <= spans[stack[-1]].t1):
            stack.pop()
        if stack:
            out[stack[-1]] -= s.dur
        stack.append(i)
    return out


def attach_pipeline(tracer: Optional[Tracer], pipeline) -> None:
    """Wire a tracer into a lock-step pipeline: every ``Stage.run`` emits a
    per-batch service span.  The staged/elastic executors do NOT use this —
    they emit richer per-item spans (queue wait, replica id, retry index)
    themselves, and attaching both would double-record service time."""
    pipeline.tracer = tracer
    for st in pipeline.stages:
        st.tracer = tracer
