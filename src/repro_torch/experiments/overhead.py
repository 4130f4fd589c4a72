"""Tracing-overhead gate: span recording must be ≤3% on throughput and p99
(the port of ``benchmarks/overhead.py``).

The observability layer (``repro_torch.obs``) rides the serving hot path —
queue spans, coalesce spans, per-item service spans, request spans — so its
cost must be pinned, not assumed.  This experiment serves the ``steady``
scenario live through the elastic executor (fixed, provisioned replica
pools — no autoscaler, see ``_serve_once``) twice per round,
**interleaved** and order-alternated, then compares per configuration:

* throughput — median of per-round achieved QPS;
* p99        — median of per-round p99s (a tail order statistic jitters
  several percent per round from scheduler noise alone; the median is
  robust to one stall landing on either side, where a pooled p99 hands
  the whole comparison to the single worst round).

``--check`` asserts the pinned budget:

    throughput_on >= (1 - tol) * throughput_off
    p99_on        <= (1 + tol) * p99_off          (tol = 3%)

A failed check automatically re-measures once with doubled rounds before
declaring a regression (``gate``).
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.obs import Tracer, WallClock
from repro_torch.scenarios import ScenarioRunner, get_scenario
from repro_torch.scenarios.registry import GOLDEN_SCALE
from repro_torch.serving.accounting import percentile
from repro_torch.serving.batcher import BatchPolicy
from repro_torch.serving.elastic import ElasticExecutor
from repro_torch.serving.harness import ServingConfig, ServingHarness

TOLERANCE = 0.03
SCENARIO = "steady"


def _serve_once(spec, tracer: Optional[Tracer], batch: int = 8,
                batch_timeout_s: float = 0.005, device="cuda"
                ) -> Tuple[float, List[float], int]:
    """One live pass; returns (achieved_qps, ok-query latencies ms, n_spans).

    Mirrors ``ScenarioRunner.serve`` construction but keeps the raw request
    records (pooling latencies across runs needs samples, not summaries)
    and pins the configuration: fixed replica pools, no autoscaler.  A
    controller firing a batch-size event mid-run runs a batch shape no
    warm-up ran (the first call of a shape pays the device's lazy paths),
    a stall landing on whichever config is unlucky — exactly the
    nondeterminism a tracing-on/off A/B must exclude.  Quality evaluation
    is off; it runs after the clock stops either way.
    """
    runner = ScenarioRunner(spec, device=device)
    pipe, corpus = runner._build()
    # coalescing yields every batch shape 1..batch; run them all now so no
    # measured run ever pays a first-shape cost in its tail
    for n in range(1, batch + 1):
        pipe.query(["warmup query"] * n)
    pipe.traces.clear()
    scfg = ServingConfig(
        arrival=spec.arrival_config(),
        policy=BatchPolicy(max_batch=batch, max_wait_s=batch_timeout_s,
                           priority=spec.priority),
        slo_ms=spec.slo_ms, evaluate=False)
    pspec = spec.pipeline_spec()
    # provision retrieval at 2 replicas: the spec's single replica runs
    # near full occupancy under steady load, and at the knee of the
    # queueing curve µs-level perturbations amplify into ms-level tail
    # noise — the A/B must price tracing, not saturation amplification
    replicas = dict(pspec.stage_replicas())
    replicas["retrieval"] = max(2, replicas.get("retrieval", 1))
    executor = ElasticExecutor(
        pipe, replicas=replicas,
        batch_sizes=pspec.stage_batch_sizes(), default_batch=batch,
        tracer=tracer)
    harness = ServingHarness(pipe, corpus, spec.workload_config(), scfg,
                             executor=executor, tracer=tracer)
    res = harness.run()
    lat_ms = [r.latency_s * 1e3 for r in res.records
              if r.op == "query" and r.ok]
    return (float(res.summary.get("achieved_qps", 0.0)), lat_ms,
            len(tracer) if tracer is not None else 0)


def measure(scale: float = 1.0, runs: int = 3,
            device="cuda") -> Dict[str, float]:
    """Interleaved off/on rounds → pooled-latency percentiles and median
    throughput per configuration."""
    device = resolve_device(device)
    spec = get_scenario(SCENARIO)
    if scale != 1.0:
        spec = spec.scaled(scale)
    tputs: Dict[str, List[float]] = {"off": [], "on": []}
    pooled: Dict[str, List[float]] = {"off": [], "on": []}
    p99s: Dict[str, List[float]] = {"off": [], "on": []}
    n_spans = 0
    t0 = time.perf_counter()
    # discarded: cold allocation and first-call paths warm here,
    _serve_once(spec, None, device=device)
    for i in range(runs):     # not inside the first measured (off) round
        # alternate which config goes first so any position-correlated
        # stall (residual warmup, allocator growth) charges both equally
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            tracer = Tracer(clock=WallClock()) if mode == "on" else None
            # the previous run's pipeline is garbage by now; collect it
            # here so a stop-the-world pause never lands mid-measurement
            gc.collect()
            tput, lat, spans = _serve_once(spec, tracer, device=device)
            tputs[mode].append(tput)
            pooled[mode].extend(lat)
            p99s[mode].append(percentile(lat, 99))
            n_spans = max(n_spans, spans)
    out: Dict[str, float] = {
        "runs": float(runs), "scale": scale,
        "n_samples_off": float(len(pooled["off"])),
        "n_samples_on": float(len(pooled["on"])),
        "n_spans": float(n_spans),
        "wall_s": time.perf_counter() - t0,
    }
    for mode in ("off", "on"):
        out[f"tput_{mode}_qps"] = percentile(tputs[mode], 50)
        for q in (50, 95):
            out[f"p{q}_{mode}_ms"] = percentile(pooled[mode], q)
        # the gate's p99 is the *median of per-round p99s*: a tail order
        # statistic jitters several percent per round, and a pooled p99
        # hands the whole comparison to the single worst round — the
        # median is robust to one unlucky scheduler stall on either side
        out[f"p99_{mode}_ms"] = percentile(p99s[mode], 50)
        out[f"p99_{mode}_pooled_ms"] = percentile(pooled[mode], 99)
        out[f"mean_{mode}_ms"] = (sum(pooled[mode]) / len(pooled[mode])
                                  if pooled[mode] else 0.0)
    out["tput_ratio"] = (out["tput_on_qps"] / out["tput_off_qps"]
                         if out["tput_off_qps"] else 1.0)
    out["p99_ratio"] = (out["p99_on_ms"] / out["p99_off_ms"]
                        if out["p99_off_ms"] else 1.0)
    return out


def violations(m: Dict[str, float], tol: float = TOLERANCE) -> List[str]:
    out = []
    if m["tput_ratio"] < 1.0 - tol:
        out.append(f"throughput: tracing-on {m['tput_on_qps']:.2f} QPS < "
                   f"{1.0 - tol:.2f}x tracing-off {m['tput_off_qps']:.2f} "
                   f"QPS (ratio {m['tput_ratio']:.4f})")
    if m["p99_ratio"] > 1.0 + tol:
        out.append(f"p99 latency: tracing-on {m['p99_on_ms']:.2f} ms > "
                   f"{1.0 + tol:.2f}x tracing-off {m['p99_off_ms']:.2f} ms "
                   f"(ratio {m['p99_ratio']:.4f})")
    return out


def gate(m: Dict[str, float], scale: float, runs: int, device="cuda",
         say=print) -> Tuple[Dict[str, float], List[str]]:
    """``--check``: ``m``'s violations, after one re-measure at doubled
    rounds if there were any (tail noise and real regressions look alike
    at one sample size). Returns the measurement it judged and the
    violations left."""
    bad = violations(m)
    if bad:
        say("re-measuring with doubled rounds: " + "; ".join(bad))
        m = measure(scale, runs * 2, device)
        say(f"retry ratios: throughput {m['tput_ratio']:.4f}, "
            f"p99 {m['p99_ratio']:.4f}")
        bad = violations(m)
    return m, bad


def row_of(m: Dict[str, float]) -> Dict:
    """A measurement as ``run``'s row."""
    return {"bench": "overhead/steady",
            **{k: round(v, 4) for k, v in m.items()}}


def run(scale: float = 1.0, device="cuda", runs: int = 3) -> List[Dict]:
    """``experiments.run`` entry point: one row for the overhead
    comparison."""
    return [row_of(measure(scale, runs, device))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help=f"golden-size stream ({GOLDEN_SCALE}x)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=3,
                    help="interleaved off/on rounds to pool")
    ap.add_argument("--check", action="store_true",
                    help=f"fail if tracing costs more than "
                         f"{TOLERANCE:.0%} throughput or p99")
    ap.add_argument("--out", default="", help="optional JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scale = GOLDEN_SCALE if args.smoke else args.scale
    m = measure(scale, args.runs, args.device)
    print(f"tracing off: {m['tput_off_qps']:.2f} QPS, "
          f"p50/p99 {m['p50_off_ms']:.2f}/{m['p99_off_ms']:.2f} ms "
          f"({int(m['n_samples_off'])} samples)")
    print(f"tracing on:  {m['tput_on_qps']:.2f} QPS, "
          f"p50/p99 {m['p50_on_ms']:.2f}/{m['p99_on_ms']:.2f} ms "
          f"({int(m['n_samples_on'])} samples, "
          f"{int(m['n_spans'])} spans/run)")
    print(f"ratios: throughput {m['tput_ratio']:.4f}, "
          f"p99 {m['p99_ratio']:.4f} (budget ±{TOLERANCE:.0%})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(m, f, indent=2, sort_keys=True)
    if args.check:
        m, bad = gate(m, scale, args.runs, args.device)
        for b in bad:
            print(f"CHECK FAILED: {b}")
        if not bad:
            print(f"CHECK OK: tracing overhead within {TOLERANCE:.0%} "
                  f"(throughput ratio {m['tput_ratio']:.4f}, "
                  f"p99 ratio {m['p99_ratio']:.4f})")
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
