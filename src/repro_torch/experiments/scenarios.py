"""Scenario suite: every registered workload scenario as a deterministic,
quality-priced experiment (the port of ``benchmarks/scenarios.py``).

Each named scenario (``repro_torch.scenarios.registry``: steady,
burst_tolerance, update_storm, mixed_interference, diurnal_ramp, the chaos
three and shard_scale) runs through the wall-clock-free simulator (seeded
arrivals + seeded workload + the real ``AutoscaleController`` + a
real-pipeline quality replay on ``device``), reporting plain SLO goodput
next to **quality-aware goodput** so knob-ladder savings are honestly
priced against their recall/answer cost.

The sim mode is bit-deterministic, so ``--check`` replays every scenario's
golden-size variant twice and fails unless the two runs' golden dicts
(scaling-event stream, knob timeline, fault log, rounded quality and
goodput; ``scenarios.golden_dict``) and fault logs are equal and the
controller's replay reproduces its live event stream (``--only NAME``
narrows it). The reference pins the same dicts in golden-trace files; this
package records none, and holds its dicts to a live reference run in its
tests instead.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

from repro_torch import resolve_device
from repro_torch.scenarios import (ScenarioRunner, diff_golden, get_scenario,
                                   golden_dict, golden_variant,
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


def check(only: str = "", device="cuda") -> List[str]:
    """Replay each scenario's golden variant twice; returns human-readable
    failures (empty = both runs equal and the controller's replay
    deterministic)."""
    device = resolve_device(device)
    failures: List[str] = []
    names = [only] if only else scenario_names()
    for name in names:
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
        for d in diff_golden(golden_dict(first, spec),
                             golden_dict(again, spec)):
            failures.append(f"{name}: {d}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="golden-size scenarios; JSON to stdout")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", default="",
                    help="restrict --check/sweep to one scenario")
    ap.add_argument("--check", action="store_true",
                    help="replay every golden variant twice, exit nonzero "
                         "on any difference")
    ap.add_argument("--out", default="", help="optional JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.only and args.only not in scenario_names():
        ap.error(f"unknown scenario {args.only!r}; "
                 f"registered: {', '.join(scenario_names())}")
    if args.check:
        failures = check(args.only, args.device)
        for f in failures:
            print(f"CHECK FAILED: {f}")
        if not failures:
            names = [args.only] if args.only else scenario_names()
            print(f"CHECK OK: {len(names)} golden scenario variant(s) "
                  f"replayed bit-for-bit")
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
