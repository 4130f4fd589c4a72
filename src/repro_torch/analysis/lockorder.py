"""Runtime lock-order detector: records the cross-thread lock-acquisition
order graph and fails on cycles (potential deadlock).

Opt-in and test-oriented: wrap each lock of interest in an
``InstrumentedLock`` (or swap one onto an object with ``instrument``),
run the workload, then ``graph.assert_acyclic()``.  An edge A -> B is
recorded when a thread *attempts* to acquire B while holding A -- attempt,
not success, because the deadlocked interleaving never returns from
``acquire``.  A cycle means two locks are taken in both orders somewhere,
i.e. some interleaving deadlocks even if this run got lucky.

Reentrant re-acquisition of a lock already held by the same thread adds no
edge (RLock semantics are order-safe against themselves).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderError(AssertionError):
    """A cycle exists in the observed lock-acquisition order graph."""


class LockOrderGraph:
    """Thread-safe accumulator of held-lock -> acquired-lock edges."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}          # name -> successors
        self._sites: Dict[Tuple[str, str], int] = {}   # edge -> observations
        self._acquires: Dict[str, int] = {}            # name -> acquisitions
        self._tls = threading.local()

    def _held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    # -- hooks called by InstrumentedLock -----------------------------------

    def note_acquire_attempt(self, name: str) -> None:
        held = self._held()
        if name in held:
            return  # reentrant: no ordering constraint against itself
        with self._mu:
            for h in held:
                if h == name:
                    continue
                self._edges.setdefault(h, set()).add(name)
                self._sites[(h, name)] = self._sites.get((h, name), 0) + 1

    def note_acquired(self, name: str) -> None:
        self._held().append(name)
        with self._mu:
            self._acquires[name] = self._acquires.get(name, 0) + 1

    def note_released(self, name: str) -> None:
        held = self._held()
        # release in LIFO order is typical but not required (lock handoff)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- analysis -----------------------------------------------------------

    def edges(self) -> List[Tuple[str, str]]:
        with self._mu:
            return sorted((a, b) for a, succ in self._edges.items()
                          for b in succ)

    def acquisitions(self) -> Dict[str, int]:
        """Per-lock acquisition counts (did the workload engage the locks?
        an empty *edge* set is the healthy no-nesting outcome, so tests
        should assert engagement on this instead)."""
        with self._mu:
            return dict(self._acquires)

    def cycles(self) -> List[List[str]]:
        """All elementary cycles found by DFS (deduplicated by rotation)."""
        with self._mu:
            edges = {a: sorted(succ) for a, succ in self._edges.items()}
        cycles: List[List[str]] = []
        seen: Set[Tuple[str, ...]] = set()

        def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
            for nxt in edges.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):]
                    k = min(range(len(cyc)), key=lambda i: cyc[i])
                    canon = tuple(cyc[k:] + cyc[:k])
                    if canon not in seen:
                        seen.add(canon)
                        cycles.append(list(canon))
                    continue
                path.append(nxt)
                on_path.add(nxt)
                dfs(nxt, path, on_path)
                on_path.discard(nxt)
                path.pop()

        for start in sorted(edges):
            dfs(start, [start], {start})
        return cycles

    def assert_acyclic(self) -> None:
        cyc = self.cycles()
        if cyc:
            desc = "; ".join(" -> ".join(c + [c[0]]) for c in cyc)
            raise LockOrderError(
                f"lock-acquisition-order cycle(s) observed (potential "
                f"deadlock): {desc}")


class InstrumentedLock:
    """Drop-in wrapper for a Lock/RLock that reports to a LockOrderGraph.

    Substitutable anywhere the inner lock was used via ``with``/
    ``acquire``/``release`` (executor ``_lock``, DB ``_mu``, timer locks).
    """

    def __init__(self, graph: LockOrderGraph, name: str,
                 inner: Optional[object] = None):
        self.graph = graph
        self.name = name
        self.inner = inner if inner is not None else threading.Lock()

    def acquire(self, *a, **kw) -> bool:
        self.graph.note_acquire_attempt(self.name)
        got = self.inner.acquire(*a, **kw)
        if got:
            self.graph.note_acquired(self.name)
        return got

    def release(self) -> None:
        self.inner.release()
        self.graph.note_released(self.name)

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        locked = getattr(self.inner, "locked", None)
        return locked() if callable(locked) else False


def instrument(obj: object, attr: str, name: str,
               graph: LockOrderGraph) -> InstrumentedLock:
    """Swap ``obj.<attr>`` (a lock) for an instrumented wrapper in place."""
    inner = getattr(obj, attr)
    if isinstance(inner, InstrumentedLock):
        return inner
    wrapped = InstrumentedLock(graph, name, inner)
    setattr(obj, attr, wrapped)
    return wrapped
