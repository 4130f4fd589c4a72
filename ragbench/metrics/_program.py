"""The program's own spans, for the readers of the vector DB's phases.

The port records them on ``repro_torch.obs.PROCESS_TRACER`` whenever a
torch profiler session runs in the process, as the traced sub-window's
does, on ``time.time_ns``'s clock (seconds), the clock of the profiler's
events and of ``TraceData``'s ``t0``/``t1`` (nanoseconds). A program without
that tracer records nothing: every reader then gives None.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


def _tracer():
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return getattr(obs, "PROCESS_TRACER", None)


def spans(td) -> Optional[list]:
    """The process tracer's spans that lie inside ``td``'s ``[t0, t1]``,
    or None where the program records none there."""
    tr = _tracer() if td is not None else None
    if tr is None:
        return None
    lo, hi = td.t0 / 1e9, td.t1 / 1e9
    got = [s for s in tr.spans() if s.t0 >= lo and s.t1 <= hi]
    return got or None


def phase_ms_per_call(td, phases) -> Optional[float]:
    """Milliseconds of the ``phases`` spans of each ``db.search`` call in the
    sub-window, summed over its calls and divided by their number."""
    sp = spans(td)
    if sp is None:
        return None
    # a call's phases share its OS thread and ``req``
    searches = {(s.thread, s.req) for s in sp if s.name == "db.search"}
    if not searches:
        return None
    tot = sum(s.t1 - s.t0 for s in sp
              if s.name in phases and (s.thread, s.req) in searches)
    return 1e3 * tot / len(searches)


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = tot = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_in_db_s(td) -> Optional[float]:
    """Seconds of the sub-window in which the device runs nothing while
    some program ``db.*`` span is open (spans cut to the sub-window); None
    without device operations or program spans there. The device's busy
    intervals are ``TraceData``'s, so the idle share splits exactly."""
    tr = _tracer() if td is not None else None
    if tr is None or td.busy_s <= 0:
        return None
    lo, hi = td.t0, td.t1
    db = _union([(max(int(s.t0 * 1e9), lo), min(int(s.t1 * 1e9), hi))
                 for s in tr.spans() if s.name.startswith("db.")
                 and s.t1 * 1e9 > lo and s.t0 * 1e9 < hi])
    if not db:
        return None
    dev = _union([(max(s, lo), min(s + d, hi)) for _, s, d, _ in
                  td.device_ops if s + d > lo and s < hi])
    in_db = sum(b - a for a, b in db) - _overlap(db, dev)
    return in_db / 1e9
