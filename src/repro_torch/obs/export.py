"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and JSONL.

``chrome_trace_doc`` renders a ``Tracer`` (plus, optionally, a
``MetricsRegistry``) as the Trace Event Format both chrome://tracing and
Perfetto open directly: spans as ``"ph": "X"`` complete events, instants as
``"ph": "i"``, registry gauge/counter series as ``"ph": "C"`` counter
tracks, and registry events (autoscale decisions) as global instants —
everything in microseconds on the tracer's one clock.

``validate_chrome_trace`` is the schema gate of
``python -m repro_torch.obs.export <trace.json>``: it checks the invariants a
trace viewer actually needs (event array, name/ph fields, numeric
non-negative ts/dur, pid/tid on duration events) without any external
dependency.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer

_PID = 1
_PHASES = {"X", "i", "I", "C", "M", "B", "E"}


def _tid_table(names: List[str]) -> Dict[str, int]:
    """Stable logical-track -> integer tid mapping (sorted = deterministic)."""
    return {name: i + 1 for i, name in enumerate(sorted(set(names)))}


def chrome_trace_doc(tracer: Tracer,
                     registry: Optional[MetricsRegistry] = None,
                     process: str = "ragperf") -> Dict[str, object]:
    """Render tracer (+ registry) as a Chrome ``trace_event`` document."""
    spans = tracer.spans()
    instants = tracer.instants()
    tids = _tid_table([s.tid for s in spans] + [e.tid for e in instants])
    events: List[Dict[str, object]] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": process}}]
    for tname, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": tname}})
    for s in spans:
        args = dict(s.args)
        if s.req >= 0:
            args["req"] = s.req
        events.append({"name": s.name, "cat": s.cat or "span", "ph": "X",
                       "ts": s.t0 * 1e6, "dur": max(s.dur, 0.0) * 1e6,
                       "pid": _PID, "tid": tids[s.tid], "args": args})
    for e in instants:
        args = dict(e.args)
        if e.req >= 0:
            args["req"] = e.req
        events.append({"name": e.name, "cat": e.cat or "instant", "ph": "i",
                       "ts": e.t * 1e6, "s": "t",
                       "pid": _PID, "tid": tids[e.tid], "args": args})
    if registry is not None:
        for p in registry.timeline():
            if p.kind == "event":
                events.append({"name": p.name, "cat": "metric_event",
                               "ph": "i", "ts": p.t * 1e6, "s": "g",
                               "pid": _PID, "tid": 0, "args": dict(p.args)})
            else:
                events.append({"name": p.name, "cat": p.kind, "ph": "C",
                               "ts": p.t * 1e6, "pid": _PID,
                               "args": {"value": p.value}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer: Tracer,
                       registry: Optional[MetricsRegistry] = None,
                       process: str = "ragperf") -> str:
    doc = chrome_trace_doc(tracer, registry, process=process)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_jsonl(path: str, tracer: Tracer,
                registry: Optional[MetricsRegistry] = None) -> str:
    """Line-delimited export (one JSON object per span/instant/metric) for
    downstream tooling that streams rather than loads a whole document."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for s in tracer.spans():
            f.write(json.dumps({
                "type": "span", "name": s.name, "cat": s.cat, "tid": s.tid,
                "req": s.req, "t0": s.t0, "t1": s.t1, "args": s.args}) + "\n")
        for e in tracer.instants():
            f.write(json.dumps({
                "type": "instant", "name": e.name, "cat": e.cat,
                "tid": e.tid, "req": e.req, "t": e.t, "args": e.args}) + "\n")
        if registry is not None:
            for p in registry.timeline():
                f.write(json.dumps({
                    "type": "metric", "kind": p.kind, "name": p.name,
                    "t": p.t, "value": p.value, "args": p.args}) + "\n")
    return path


def validate_chrome_trace(doc) -> List[str]:
    """Schema errors for a Chrome trace document ([] == viewer-openable)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid 'traceEvents' array"]
    if not events:
        errs.append("'traceEvents' is empty")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errs.append(f"{where}: missing 'name'")
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"{where}: invalid phase {ph!r}")
            continue
        if ph == "M":
            continue                      # metadata events carry no ts
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: invalid 'ts' {ts!r}")
        if "pid" not in ev:
            errs.append(f"{where}: missing 'pid'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: invalid 'dur' {dur!r}")
            if "tid" not in ev:
                errs.append(f"{where}: missing 'tid'")
        if len(errs) >= 20:
            errs.append("... (truncated)")
            break
    return errs


def main(argv=None) -> int:
    """``python -m repro_torch.obs.export trace.json``: load and validate
    each trace, nonzero exit on any error."""
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m repro_torch.obs.export <trace.json> [...]")
        return 2
    bad = 0
    for path in args:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable trace: {e}")
            bad += 1
            continue
        errs = validate_chrome_trace(doc)
        for e in errs:
            print(f"{path}: {e}")
        if errs:
            bad += 1
        else:
            n = len(doc["traceEvents"])
            print(f"{path}: OK ({n} trace events)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
