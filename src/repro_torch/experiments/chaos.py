"""Chaos suite: the three fault-injection scenarios as a deterministic
recovery experiment (the port of ``benchmarks/chaos.py``).

Each chaos scenario (``repro_torch.scenarios.registry``: replica_failure,
straggler_degrade, writer_stall) replays through the wall-clock-free
simulator, reporting availability / error-rate / retry traffic next to the
recovery event stream (kill -> respawn pairs, straggler retires, writer
stall -> drain).

``--check`` asserts the recovery contract end to end:

* bit-determinism — two runs of every chaos scenario produce identical
  golden dicts and fault logs;
* losslessness — every request reaches a terminal state
  (availability + error_rate == 1) and the replica-kill scenario loses
  nothing (availability == 1) while still exercising the requeue path;
* recovery — each kill is followed by its respawn ``respawn_delay_s``
  later, the straggler is retired by the controller (and the retire
  replays deterministically), and the writer stall shows up as a
  mutation-latency spike over the fault-free baseline before draining.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

from repro_torch import resolve_device
from repro_torch.scenarios import ScenarioRunner, golden_dict, golden_variant
from repro_torch.scenarios.registry import GOLDEN_SCALE
from repro_torch.serving.faults import FaultSpec

CHAOS_SCENARIOS = ("replica_failure", "straggler_degrade", "writer_stall")


def _simulate(name: str, scale: float, device="cuda"):
    spec = golden_variant(name) if scale == GOLDEN_SCALE else \
        golden_variant(name).scaled(scale / GOLDEN_SCALE)
    return spec, ScenarioRunner(spec, device=device).simulate()


def sweep(scale: float = 1.0, device="cuda") -> Dict[str, Dict]:
    device = resolve_device(device)
    return {name: _simulate(name, scale, device)[1].to_dict()
            for name in CHAOS_SCENARIOS}


def run(scale: float = 1.0, device="cuda") -> List[Dict]:
    """``experiments.run`` entry point: one recovery row per chaos
    scenario."""
    rows = []
    for name, doc in sweep(scale, device).items():
        s = doc["summary"]
        ev = doc["fault_events"]
        rows.append({
            "bench": f"chaos/{name}",
            "n_requests": doc["n_requests"],
            "availability": s.get("availability", 1.0),
            "error_rate": s.get("error_rate", 0.0),
            "n_failed": s.get("n_failed", 0.0),
            "n_retried": s.get("n_retried", 0.0),
            "p95_latency_ms": s.get("p95_latency_ms", 0.0),
            "slo_attainment": s.get("slo_attainment", 0.0),
            "n_faults_injected": sum(1 for e in ev
                                     if e["action"] == "inject"),
            "n_respawns": sum(1 for e in ev if e["action"] == "respawn"),
            "n_retires": sum(1 for e in doc["scaling_events"]
                             if e["kind"] == "retire"),
            "deterministic": float(doc["deterministic_replay"]),
        })
    return rows


def check(device="cuda") -> List[str]:
    """Assert the chaos recovery contract; returns human-readable
    failures."""
    device = resolve_device(device)
    failures: List[str] = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failures.append(msg)

    reports = {}
    for name in CHAOS_SCENARIOS:
        spec = golden_variant(name)
        a = ScenarioRunner(spec, device=device).simulate()
        b = ScenarioRunner(spec, device=device).simulate()
        expect(golden_dict(a, spec) == golden_dict(b, spec),
               f"{name}: recovery timeline is not bit-deterministic")
        expect(a.fault_events == b.fault_events,
               f"{name}: fault log differs between identical runs")
        s = a.summary
        terminal = s.get("availability", 0.0) + s.get("error_rate", 0.0)
        expect(abs(terminal - 1.0) < 1e-9,
               f"{name}: availability+error_rate = {terminal:.6f} != 1 "
               f"(some requests never reached a terminal state)")
        expect(a.deterministic_replay,
               f"{name}: controller replay diverged from the live stream")
        reports[name] = (spec, a)

    # replica_failure: zero lost requests, and the kills actually landed
    # mid-batch (requeues happened) with each respawn on its delay
    spec, rep = reports["replica_failure"]
    s = rep.summary
    expect(s.get("availability") == 1.0 and s.get("n_failed") == 0.0,
           f"replica_failure: lost requests (availability "
           f"{s.get('availability')}, n_failed {s.get('n_failed')})")
    expect(s.get("n_retried", 0.0) > 0,
           "replica_failure: kills hit idle replicas only — the requeue "
           "path went unexercised")
    kills = [e for e in rep.fault_events
             if e["action"] == "inject" and e["kind"] == "replica_kill"]
    spawns = [e for e in rep.fault_events if e["action"] == "respawn"]
    expect(len(kills) == 2 and len(spawns) == 2,
           f"replica_failure: expected 2 kill->respawn pairs, got "
           f"{len(kills)} kills / {len(spawns)} respawns")
    for k, r in zip(kills, spawns):
        dt = r["t_s"] - k["t_s"]
        expect(abs(dt - spec.faults.respawn_delay_s) < 1e-9,
               f"replica_failure: respawn {dt:.3f}s after kill, want "
               f"{spec.faults.respawn_delay_s}s")

    # straggler_degrade: detection fed the controller, which retired the
    # slowed replica exactly once
    _, rep = reports["straggler_degrade"]
    retires = [e for e in rep.scaling_events if e["kind"] == "retire"]
    expect(len(retires) == 1,
           f"straggler_degrade: {len(retires)} retire events, want 1")
    if retires:
        expect(retires[0]["stage"] == "retrieval",
               f"straggler_degrade: retired {retires[0]['stage']}, "
               f"want retrieval")

    # writer_stall: the freeze spikes mutation latency well above the
    # fault-free baseline, then the backlog drains (availability 1)
    spec, rep = reports["writer_stall"]
    base = ScenarioRunner(spec.replace(faults=FaultSpec()),
                          device=device).simulate()
    p95 = rep.summary.get("p95_mutation_latency_ms", 0.0)
    base_p95 = base.summary.get("p95_mutation_latency_ms", 0.0)
    expect(p95 > 5 * base_p95,
           f"writer_stall: mutation p95 {p95:.1f}ms vs baseline "
           f"{base_p95:.1f}ms — the stall left no mark")
    expect(rep.summary.get("availability") == 1.0,
           "writer_stall: backlog failed to drain on resume")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="golden-size chaos scenarios; JSON to stdout")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--check", action="store_true",
                    help="assert the chaos recovery contract "
                         "(determinism, losslessness, recovery events)")
    ap.add_argument("--out", default="", help="optional JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.check:
        failures = check(args.device)
        for f in failures:
            print(f"CHECK FAILED: {f}")
        if not failures:
            print(f"CHECK OK: {len(CHAOS_SCENARIOS)} chaos scenarios — "
                  f"deterministic, lossless, recovery events verified")
        return 1 if failures else 0
    scale = GOLDEN_SCALE if args.smoke else args.scale
    doc = sweep(scale, args.device)
    text = json.dumps(doc, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
