"""Scenario suite: every registered workload scenario as a deterministic,
quality-priced experiment — and the golden-trace regression gate (the port
of ``benchmarks/scenarios.py``).

Each named scenario (``repro_torch.scenarios.registry``: steady,
burst_tolerance, update_storm, mixed_interference, diurnal_ramp, the chaos
three and shard_scale) runs through the wall-clock-free simulator (seeded
arrivals + seeded workload + the real ``AutoscaleController`` + a
real-pipeline quality replay on ``device``), reporting plain SLO goodput
next to **quality-aware goodput** so knob-ladder savings are honestly
priced against their recall/answer cost.

Because the sim mode is bit-deterministic, each scenario's golden dict
(scaling-event stream, knob timeline, fault log, rounded quality and
goodput; ``scenarios.golden_dict``) is pinned by a golden trace in the
port's own ``src/repro_torch/scenarios/golden/``, recorded on the CPU:

* ``--check``  — replay every scenario's golden-size variant twice and fail
  unless the first replay equals its recorded trace, the two replays'
  golden dicts and fault logs are equal, and the controller's replay
  reproduces its live event stream (``--only NAME`` narrows it);
* ``--regen``  — re-record the golden traces. Re-record only for an
  understood change of behaviour (controller policy, cost model, scenario
  catalog, quality scoring), and review the diff: a re-record that makes a
  check pass without one hides a regression.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from repro_torch import resolve_device
from repro_torch.scenarios import (ScenarioRunner, diff_golden, get_scenario,
                                   golden_dict, golden_path, golden_variant,
                                   scenario_names)
from repro_torch.scenarios.registry import GOLDEN_SCALE


def _simulate(name: str, scale: float = 1.0, device="cuda"):
    spec = get_scenario(name) if scale == 1.0 else \
        get_scenario(name).scaled(scale)
    return spec, ScenarioRunner(spec, device=device).simulate()


def sweep(scale: float = 1.0, device="cuda") -> Dict[str, Dict]:
    device = resolve_device(device)
    return {name: _simulate(name, scale, device)[1].to_dict()
            for name in scenario_names()}


def run(scale: float = 1.0, device="cuda") -> List[Dict]:
    """``experiments.run`` entry point: one row per scenario."""
    rows = []
    for name, doc in sweep(scale, device).items():
        s = doc["summary"]
        rows.append({
            "bench": f"scenarios/{name}",
            "n_requests": doc["n_requests"],
            "p95_latency_ms": s.get("p95_latency_ms", 0.0),
            "slo_attainment": s.get("slo_attainment", 0.0),
            "goodput_qps": s.get("goodput_qps", 0.0),
            "quality_goodput_qps": s.get("quality_goodput_qps", 0.0),
            "quality_weight": s.get("quality_weight_mean", 1.0),
            "n_scaling_events": len(doc["scaling_events"]),
            "n_knob_moves": len(doc["knob_timeline"]),
            "deterministic": float(doc["deterministic_replay"]),
        })
    return rows


def regen(only: str = "", device="cuda") -> List[str]:
    """Re-record golden traces at the golden size; returns written paths."""
    device = resolve_device(device)
    written = []
    for name in scenario_names():
        if only and name != only:
            continue
        spec = golden_variant(name)
        report = ScenarioRunner(spec, device=device).simulate()
        path = golden_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(golden_dict(report, spec), f, indent=2, sort_keys=True)
            f.write("\n")
        written.append(path)
    return written


def check(only: str = "", device="cuda") -> List[str]:
    """Replay each scenario's golden variant twice; returns human-readable
    failures (empty = the first run equals its recorded trace, both runs
    are equal and the controller's replay is deterministic)."""
    device = resolve_device(device)
    failures: List[str] = []
    names = [only] if only else scenario_names()
    for name in names:
        path = golden_path(name)
        if not os.path.exists(path):
            failures.append(f"{name}: no golden trace at {path} (run "
                            f"PYTHONPATH=src python -m repro_torch.experiments"
                            f".scenarios --regen --device cpu --only {name})")
            continue
        with open(path) as f:
            expected = json.load(f)
        spec = golden_variant(name)
        first = ScenarioRunner(spec, device=device).simulate()
        again = ScenarioRunner(spec, device=device).simulate()
        for report in (first, again):
            if not report.deterministic_replay:
                failures.append(f"{name}: controller replay diverged from "
                                f"its own live event stream")
        if first.fault_events != again.fault_events:
            failures.append(f"{name}: fault log differs between identical "
                            f"runs")
        recorded = golden_dict(first, spec)
        for d in diff_golden(expected, recorded):
            failures.append(f"{name}: against {path}: {d}")
        for d in diff_golden(recorded, golden_dict(again, spec)):
            failures.append(f"{name}: {d}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="golden-size scenarios; JSON to stdout")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", default="",
                    help="restrict --check/--regen/sweep to one scenario")
    ap.add_argument("--check", action="store_true",
                    help="replay every golden variant twice against its "
                         "recorded trace, exit nonzero on any difference")
    ap.add_argument("--regen", action="store_true",
                    help="re-record golden traces (review the diff!)")
    ap.add_argument("--out", default="", help="optional JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.only and args.only not in scenario_names():
        ap.error(f"unknown scenario {args.only!r}; "
                 f"registered: {', '.join(scenario_names())}")
    if args.regen:
        for path in regen(args.only, args.device):
            print(f"wrote {path}")
        print("golden traces re-recorded — review `git diff "
              "src/repro_torch/scenarios/golden/` before committing")
        return 0
    if args.check:
        failures = check(args.only, args.device)
        for f in failures:
            print(f"CHECK FAILED: {f}")
        if not failures:
            names = [args.only] if args.only else scenario_names()
            print(f"CHECK OK: {len(names)} golden scenario trace(s) "
                  f"reproduced bit-for-bit")
        return 1 if failures else 0
    scale = GOLDEN_SCALE if args.smoke else args.scale
    if args.only:
        _, report = _simulate(args.only, scale, resolve_device(args.device))
        doc: Dict[str, object] = {args.only: report.to_dict()}
    else:
        doc = sweep(scale, args.device)
    text = json.dumps(doc, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
