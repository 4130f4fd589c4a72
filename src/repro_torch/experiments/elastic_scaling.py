"""Static vs elastic serving under bursty arrivals (the control-loop
experiment; the port of ``benchmarks/elastic_scaling.py``).

Replays the *same* seeded bursty open-loop arrival schedule against two
backends built from identical pipeline state:

* ``static``  — ``ElasticExecutor`` pinned to one replica per stage, no
  controller: exactly the fixed single-worker-per-stage ``StagedExecutor``
  regime;
* ``elastic`` — the same executor with the ``AutoscaleController`` closing
  the loop: replica pools grow toward the bottleneck stage during bursts and
  the ``nprobe``/``rerank_k`` quality ladder steps down under SLO pressure
  (and back up in the silent gaps).

Reported per mode: tail latency (p50/p95/p99), SLO attainment and goodput,
plus the elastic run's scaling-event count and knob-degradation timeline.
Two invariants ride along and are asserted under ``--check``:

* equivalence — with autoscaling and knob adaptation disabled, elastic
  replica pools produce outputs identical to lock-step execution;
* determinism — replaying the controller's recorded snapshot stream through
  a fresh controller reproduces the scaling-event sequence exactly; and the
  headline: elastic SLO goodput (or p99) must be no worse than static.

``python -m repro_torch.experiments.elastic_scaling --smoke --check
--device cpu`` runs the check on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.registry import build
from repro_torch.experiments.common import make_corpus
from repro_torch.scenarios.registry import get_scenario
from repro_torch.serving.autoscale import (AutoscaleConfig, AutoscaleController,
                                           default_ladder)
from repro_torch.serving.batcher import BatchPolicy
from repro_torch.serving.elastic import ElasticExecutor
from repro_torch.serving.harness import ServingConfig, ServingHarness
from repro_torch.workload.runner import gold_chunks_for

# the workload under test is the registered burst-tolerance scenario: this
# experiment inherits its SLO, burst shape, pipeline knobs and replica cap,
# so the knob soup lives in exactly one place (the scenario catalog)
SCENARIO = get_scenario("burst_tolerance")
SLO_MS = SCENARIO.slo_ms
BATCH = SCENARIO.autoscale.max_batch
NPROBE = int(SCENARIO.pipeline_spec().vectordb.options["nprobe"])
MAX_REPLICAS = SCENARIO.autoscale.max_replicas


def _fresh_pipeline(n_docs: int, seed: int, device="cuda"):
    corpus = make_corpus(n_docs, seed=seed)
    # the scenario's pipeline spec: serving-scale IVF (capacity sizes the
    # bucket gather so per-search cost stays proportional to the corpus)
    pipe = build(SCENARIO.pipeline_spec(), device=device)
    pipe.index_documents(corpus.all_documents())
    return pipe, corpus


def _warm_shapes(pipe, ladder, batch: int = BATCH) -> None:
    """Run every search variant the run can hit once before the clock:
    every coalesced batch size at every ladder ``nprobe`` level (the first
    call of a shape pays the device's lazy paths: allocator growth, library
    handles, a kernel's first load; it must not pollute the tail)."""
    qv = pipe.embedder.embed([f"warmup query {i}" for i in range(batch)])
    base = pipe.db.cfg.nprobe
    levels = sorted({step[0] for step in ladder} | {base})
    for nprobe in levels:
        pipe.db.set_nprobe(nprobe)
        for bs in range(1, batch + 1):
            pipe.db.search(qv[:bs], pipe.spec.retrieve_k)
    pipe.db.set_nprobe(base)


def _serve(n_docs: int, n_requests: int, target_qps: float, seed: int,
           mode: str, device="cuda") -> Dict[str, object]:
    """One serving pass.  ``mode``: ``static`` (1 replica/stage, no
    controller), ``elastic`` (replica + knob control), or ``knobs`` (replica
    pools pinned at 1 — the quality ladder is the only lever, isolating the
    RAG-Stack axis)."""
    assert mode in ("static", "elastic", "knobs"), mode
    pipe, corpus = _fresh_pipeline(n_docs, seed, device)
    ladder = default_ladder(NPROBE, pipe.spec.rerank_k)
    _warm_shapes(pipe, ladder[:1] if mode == "static" else ladder)
    max_replicas = MAX_REPLICAS if mode == "elastic" else 1
    executor = ElasticExecutor(pipe, default_batch=BATCH,
                               max_replicas=max_replicas)
    controller: Optional[AutoscaleController] = None
    if mode != "static":
        # max_batch == BATCH pins batch sizes: replica + knob scaling are
        # the levers under test, and batch growth would hit unwarmed shapes
        controller = AutoscaleController(
            AutoscaleConfig(interval_s=0.05, max_replicas=max_replicas,
                            slo_ms=SLO_MS, max_batch=BATCH, ladder=ladder),
            executor=executor)
    wcfg = SCENARIO.mix.config(n_requests=n_requests, seed=seed)
    acfg = dataclasses.replace(
        SCENARIO.arrival.config(n_requests=n_requests, seed=seed),
        target_qps=target_qps)
    scfg = ServingConfig(
        arrival=acfg,
        policy=BatchPolicy(max_batch=BATCH, max_wait_s=0.005),
        slo_ms=SLO_MS, evaluate=False)
    harness = ServingHarness(pipe, corpus, wcfg, scfg, executor=executor)
    if controller is not None:
        controller.start()
    try:
        res = harness.run()
    finally:
        if controller is not None:
            controller.stop()
    s = res.summary
    out: Dict[str, object] = {
        "mode": mode,
        "offered_qps": s.get("offered_qps", 0.0),
        "achieved_qps": s.get("achieved_qps", 0.0),
        "p50_ms": s.get("p50_latency_ms", 0.0),
        "p95_ms": s.get("p95_latency_ms", 0.0),
        "p99_ms": s.get("p99_latency_ms", 0.0),
        "slo_attainment": s.get("slo_attainment", 0.0),
        "goodput_qps": s.get("goodput_qps", 0.0),
        "stage_report": [st.row() for st in executor.stats],
    }
    if controller is not None:
        replay = controller.replay_events()
        out["n_events"] = len(controller.events)
        out["events"] = controller.event_dicts()
        out["knob_timeline"] = controller.knob_timeline()
        out["final_knobs"] = dict(executor.knobs)
        out["deterministic_replay"] = (
            [e.to_dict() for e in replay] == controller.event_dicts())
    return out


def _equivalence_check(n_docs: int, seed: int, device="cuda") -> bool:
    """Autoscaling + knobs disabled ⇒ elastic output == lock-step output."""
    pipe, corpus = _fresh_pipeline(n_docs, seed, device)
    rng = np.random.default_rng(seed)
    qs, ans, golds = [], [], []
    for d in range(min(16, corpus.cfg.n_docs)):
        q, a = corpus.question_for(d, rng)
        qs.append(q)
        ans.append(a)
        golds.append(gold_chunks_for(pipe.db, d, a))
    lock = []
    for lo in range(0, len(qs), 4):
        lock.extend(pipe.query(qs[lo:lo + 4], ground_truth=ans[lo:lo + 4],
                               gold_chunks=golds[lo:lo + 4]))
    pipe.traces.clear()
    res = ElasticExecutor(pipe, replicas={"retrieval": 2, "generation": 2},
                          default_batch=4, max_replicas=4).run(
        qs, ground_truth=ans, gold_chunks=golds)
    return ([t.answer for t in res.traces] == [t.answer for t in lock]
            and [t.retrieved_ids for t in res.traces]
            == [t.retrieved_ids for t in lock]
            and [t.reranked_ids for t in res.traces]
            == [t.reranked_ids for t in lock])


def sweep(scale: float = 1.0, seed: int = 0,
          device="cuda") -> Dict[str, object]:
    device = resolve_device(device)
    n_docs = max(32, int(48 * scale))
    n_requests = max(80, int(160 * scale))
    target_qps = SCENARIO.arrival.target_qps
    static = _serve(n_docs, n_requests, target_qps, seed, "static", device)
    elastic = _serve(n_docs, n_requests, target_qps, seed, "elastic",
                     device)
    # knob-only mode runs at 2x offered load: one replica per stage cannot
    # keep up, so the controller must walk the quality ladder down to hold
    # the SLO — the RAG-Stack quality-for-latency trade in isolation
    knobs = _serve(n_docs, n_requests, 2 * target_qps, seed, "knobs",
                   device)
    return {
        "slo_ms": SLO_MS,
        "static": static,
        "elastic": elastic,
        "knobs": knobs,
        "equivalent_outputs": _equivalence_check(n_docs, seed, device),
        "goodput_gain": (elastic["goodput_qps"]
                         / max(static["goodput_qps"], 1e-9)),
        "p99_gain": (static["p99_ms"] / max(elastic["p99_ms"], 1e-9)),
    }


def check(doc: Dict[str, object]) -> List[str]:
    """Acceptance assertions; returns human-readable failures (empty=pass)."""
    failures = []
    if not doc["equivalent_outputs"]:
        failures.append("elastic outputs diverged from lock-step")
    if not doc["elastic"].get("deterministic_replay", False):
        failures.append("controller replay diverged from live event stream")
    st, el = doc["static"], doc["elastic"]
    if el["goodput_qps"] < st["goodput_qps"] and el["p99_ms"] > st["p99_ms"]:
        failures.append(
            f"elastic worse on both axes: goodput {el['goodput_qps']:.2f} < "
            f"{st['goodput_qps']:.2f} and p99 {el['p99_ms']:.0f} > "
            f"{st['p99_ms']:.0f}")
    return failures


def rows_of(doc: Dict[str, object]) -> List[Dict]:
    """A sweep's document as ``run``'s rows."""
    rows = []
    for mode in ("static", "elastic", "knobs"):
        p = doc[mode]
        rows.append({"bench": f"elastic_scaling/{mode}",
                     "achieved_qps": p["achieved_qps"],
                     "p99_ms": p["p99_ms"],
                     "slo_attainment": p["slo_attainment"],
                     "goodput_qps": p["goodput_qps"]})
    rows.append({"bench": "elastic_scaling/gain",
                 "goodput_gain": doc["goodput_gain"],
                 "p99_gain": doc["p99_gain"],
                 "n_events": doc["elastic"].get("n_events", 0),
                 "equivalent": float(doc["equivalent_outputs"])})
    return rows


def run(scale: float = 1.0, device="cuda") -> List[Dict]:
    """``experiments.run`` entry point: static vs elastic rows."""
    return rows_of(sweep(scale, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus/request counts; JSON to stdout")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless elastic >= static on SLO "
                         "goodput or p99, outputs equivalent, and the "
                         "event stream replays deterministically")
    ap.add_argument("--out", default="", help="optional JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scale = 0.5 if args.smoke else args.scale
    doc = sweep(scale, device=args.device)
    text = json.dumps(doc, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    if args.check:
        failures = check(doc)
        for f in failures:
            print(f"CHECK FAILED: {f}")
        return 1 if failures else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
