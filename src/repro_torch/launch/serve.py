"""Serving entry point of the port:
``python -m repro_torch.launch.serve --config src/repro_torch/specs/fused_ivf.json``.

Builds the pipeline from a ``PipelineSpec`` JSON through the port's registry,
indexes a synthetic corpus and drives a seeded workload stream through it.
Every component runs on ``--device`` (default ``cuda``). ``--arch`` (with
``--smoke`` and ``--max-new``) puts a ``ModelLLM`` of that architecture in
the generator slot as the reference's flags do, ``--config`` giving the
other slots. Drive modes, as in ``repro.launch.serve``:

* ``sync``   — the offline replay (one op at a time, back-to-back);
* ``open``   — open-loop load generation (Poisson/bursty/uniform/diurnal
               arrivals at ``--target-qps``) through the continuous batcher;
* ``closed`` — closed-loop with ``--concurrency`` outstanding requests.

``--stage-pipeline`` also runs the workload's query stream through the
per-stage pipelined ``StagedExecutor`` and prints per-stage occupancy.
``--elastic`` (open/closed) swaps the backend for the ``ElasticExecutor``:
per-stage replica pools driven by an ``AutoscaleController``. ``--trace-out``
writes a Chrome/Perfetto trace plus a ``.jsonl`` sibling. ``--scenario NAME``
runs a registered scenario (``--scenario-sim``: the deterministic replay;
``--scenario list``: the catalog). ``--gen-engine`` (with ``--gen-slots``,
``--gen-chunk`` and ``--gen-admission``) serves the ``model`` generator
through the token-level continuous-batching engine, as the spec's ``gen``
block does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.core.registry import build
from repro_torch.core.spec import GenSpec, PipelineSpec, StageSpec
from repro_torch.metrics.quality import evaluate_traces
from repro_torch.monitor.monitor import MonitorConfig, ResourceMonitor
from repro_torch.obs import (MetricsRegistry, Tracer, VirtualClock, WallClock,
                             attach_pipeline, write_chrome_trace, write_jsonl)
from repro_torch.serving.arrival import ArrivalConfig
from repro_torch.serving.autoscale import AutoscaleConfig, AutoscaleController
from repro_torch.serving.batcher import BatchPolicy
from repro_torch.serving.elastic import ElasticExecutor
from repro_torch.serving.harness import ServingConfig, ServingHarness, warm_up
from repro_torch.serving.staged import StagedExecutor
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
from repro_torch.workload.generator import WorkloadConfig, WorkloadGenerator
from repro_torch.workload.runner import gold_chunks_for, run_workload

def write_trace(path: str, tracer, registry=None) -> None:
    """Emit the Chrome/Perfetto ``trace_event`` JSON plus a line-delimited
    sibling (``<path minus .json>.jsonl``) for downstream tooling."""
    write_chrome_trace(path, tracer, registry)
    stem = path[:-5] if path.endswith(".json") else path
    write_jsonl(stem + ".jsonl", tracer, registry)
    print(f"wrote {path} ({len(tracer)} trace events) and {stem}.jsonl")


def write_json(path: str, doc) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    print(f"wrote {path}")


def run_scenario(args):
    """Drive one registered scenario (live or deterministic-sim mode) and
    print/emit the unified scenario report; returns its dict."""
    from repro_torch.scenarios import (ScenarioRunner, get_scenario,
                                       scenario_names)
    if args.scenario == "list":
        for name in scenario_names():
            print(name, "-", get_scenario(name).description)
        return {"scenarios": scenario_names()}
    spec = get_scenario(args.scenario)
    if args.scenario_scale != 1.0:
        spec = spec.scaled(args.scenario_scale)
    if args.seed is not None:
        spec = spec.replace(seed=args.seed)
    runner = ScenarioRunner(spec, device=args.device)
    tracer = None
    if args.trace_out:
        # sim spans land at explicit virtual times (bit-deterministic);
        # live spans ride the run-relative wall clock
        tracer = Tracer(clock=VirtualClock() if args.scenario_sim
                        else WallClock())
    report = (runner.simulate(tracer=tracer) if args.scenario_sim
              else runner.serve(tracer=tracer))
    s = report.summary
    print(f"scenario {spec.name} ({report.mode}): "
          f"{int(s.get('n_queries', 0))} queries / "
          f"{int(s.get('n_mutations', 0))} mutations, seed {spec.seed}")
    print(f"latency p50/p95/p99 (ms): {s.get('p50_latency_ms', 0.0):.1f} / "
          f"{s.get('p95_latency_ms', 0.0):.1f} / "
          f"{s.get('p99_latency_ms', 0.0):.1f}")
    print(f"SLO {spec.slo_ms:.0f} ms: attainment "
          f"{s.get('slo_attainment', 0.0):.3f}, goodput "
          f"{s.get('goodput_qps', 0.0):.2f} QPS, quality-aware goodput "
          f"{s.get('quality_goodput_qps', 0.0):.2f} QPS "
          f"(quality weight {s.get('quality_weight_mean', 1.0):.3f})")
    print(f"scaling events: {len(report.scaling_events)}, knob moves: "
          f"{len(report.knob_timeline)}, deterministic replay: "
          f"{report.deterministic_replay}")
    if spec.faults.enabled:
        ev = report.fault_events
        n_retires = sum(1 for e in report.scaling_events
                        if e["kind"] == "retire")
        print(f"chaos: {sum(1 for e in ev if e['action'] == 'inject')} "
              f"faults injected, "
              f"{sum(1 for e in ev if e['action'] == 'respawn')} respawns, "
              f"{n_retires} straggler retires; availability "
              f"{s.get('availability', 1.0):.3f}, error rate "
              f"{s.get('error_rate', 0.0):.3f} "
              f"({int(s.get('n_failed', 0))} failed / "
              f"{int(s.get('n_retried', 0))} retried)")
    print("quality:", {k: round(v, 3) for k, v in report.quality.items()})
    if report.trace_decomposition:
        parts = [f"{c} {v.get('p95_ms', 0.0):.2f}"
                 for c, v in report.trace_decomposition.items()]
        print("critical path p95 (ms):", ", ".join(parts))
    if tracer is not None:
        registry = MetricsRegistry()
        registry.absorb_stage_rows(report.stage_report, t=0.0)
        registry.absorb_scale_events(report.scaling_events)
        write_trace(args.trace_out, tracer, registry)
    doc = report.to_dict()
    if args.json_out:
        write_json(args.json_out, doc)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve the RAG pipeline of the PyTorch/CUDA port.")
    ap.add_argument("--config", default="", help="PipelineSpec JSON")
    ap.add_argument("--arch", default="",
                    help="serve a ModelLLM of this architecture in the llm "
                         "slot (any id of repro_torch.configs)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the reduced smoke config")
    ap.add_argument("--max-new", type=int, default=8,
                    help="with --arch: tokens generated per request")
    ap.add_argument("--docs", type=int, default=64)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--update-frac", type=float, default=0.1)
    ap.add_argument("--distribution", default="uniform",
                    choices=["uniform", "zipfian"])
    ap.add_argument("--device", default="cuda",
                    help="device of every component (cuda or cpu)")
    ap.add_argument("--monitor-out", default="")
    # continuous-batching generation engine (token-level scheduling)
    ap.add_argument("--gen-engine", action="store_true",
                    help="serve generation through the token-level "
                         "continuous-batching engine (model llm only)")
    ap.add_argument("--gen-slots", type=int, default=4,
                    help="KV-cache slot pool size for --gen-engine")
    ap.add_argument("--gen-chunk", type=int, default=32,
                    help="chunked-prefill granularity for --gen-engine")
    ap.add_argument("--gen-admission", default="fcfs",
                    choices=["fcfs", "sjf"],
                    help="slot admission policy for --gen-engine")
    ap.add_argument("--json-out", default="",
                    help="write the run document (summary, per-stage "
                         "occupancy table, scaling events, quality, stage "
                         "breakdown, DB stats) as JSON")
    # serving-mode flags
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "open", "closed"])
    ap.add_argument("--stage-pipeline", action="store_true",
                    help="also run the query stream through the per-stage "
                         "pipelined executor and print stage occupancy")
    ap.add_argument("--target-qps", type=float, default=20.0,
                    help="offered load for --mode open")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO (default: the spec's autoscale block "
                         "when elastic, else 500)")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="in-flight cap for --mode closed")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "uniform", "diurnal"])
    ap.add_argument("--ramp-period-s", type=float, default=8.0,
                    help="diurnal arrivals: one trough→peak→trough period")
    ap.add_argument("--ramp-amplitude", type=float, default=0.8,
                    help="diurnal arrivals: rate swing around the mean")
    ap.add_argument("--batch-timeout-ms", type=float, default=20.0,
                    help="continuous-batching coalesce deadline")
    ap.add_argument("--priority", default="fifo",
                    choices=["fifo", "query_first", "mutation_first"])
    # elastic serving flags
    ap.add_argument("--elastic", action="store_true",
                    help="serve through per-stage replica pools with the "
                         "occupancy-driven autoscaler (open/closed modes)")
    ap.add_argument("--max-replicas", type=int, default=0,
                    help="replica cap per stage (0 = spec autoscale block)")
    ap.add_argument("--autoscale-interval-ms", type=float, default=0.0,
                    help="controller cadence (0 = spec autoscale block)")
    ap.add_argument("--trace-out", default="",
                    help="record per-request spans and write a Chrome/"
                         "Perfetto trace_event JSON (plus a .jsonl sibling); "
                         "with --scenario-sim the trace is bit-deterministic")
    # scenario suite (repro_torch.scenarios): named, seeded scenarios
    ap.add_argument("--scenario", default="",
                    help="run a registered benchmark scenario by name "
                         "('list' prints the catalog); overrides the "
                         "flag-assembled workload")
    ap.add_argument("--scenario-sim", action="store_true",
                    help="run the scenario as the wall-clock-free "
                         "deterministic replay instead of live serving")
    ap.add_argument("--scenario-scale", type=float, default=1.0,
                    help="corpus/stream size multiplier for --scenario")
    # default None so run_scenario can tell "--seed 0" from "not given"
    # (a scenario's own seed must only be overridden explicitly)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    if args.scenario:
        return run_scenario(args)
    if args.seed is None:
        args.seed = 0
    if args.target_qps <= 0:
        ap.error("--target-qps must be > 0")
    if args.concurrency < 1:
        ap.error("--concurrency must be >= 1")
    if not args.config:
        ap.error("need --config spec.json (or --scenario NAME)")
    if args.elastic and args.mode == "sync":
        ap.error("--elastic needs --mode open or closed")

    spec = PipelineSpec.from_file(args.config)
    if args.arch:
        # the reference's flag mapping (repro.launch.serve.spec_from_args):
        # the serving driver runs its generator with a short prompt
        spec.llm = StageSpec("model", {
            "arch": args.arch, "smoke": args.smoke, "batch_size": args.batch,
            "max_new": args.max_new, "max_prompt": 128},
            batch_size=args.batch)
    if args.gen_engine:
        if spec.llm.component != "model":
            ap.error("--gen-engine needs the 'model' llm "
                     "(--arch or a spec with llm.component == 'model')")
        spec = dataclasses.replace(spec, gen=GenSpec(
            enabled=True, slots=args.gen_slots, chunk_tokens=args.gen_chunk,
            admission=args.gen_admission))
    # --elastic forces it; otherwise the spec's autoscale block opts in
    elastic_on = args.elastic or (args.mode != "sync"
                                  and spec.autoscale.enabled)
    slo_ms = (args.slo_ms if args.slo_ms is not None
              else spec.autoscale.slo_ms if elastic_on else 500.0)
    pipe = build(spec, device=args.device)
    tracer = registry = None
    if args.trace_out:
        tracer = Tracer(clock=WallClock())
        registry = MetricsRegistry(clock=tracer.clock)
        if not elastic_on:
            # lock-step / staged paths: batch-level stage spans; the elastic
            # executor records richer per-item spans itself (never both)
            attach_pipeline(tracer, pipe)
        if hasattr(pipe.db, "tracer"):
            # the DB's phase spans (a sharded DB: its fan-out and merge)
            pipe.db.tracer = tracer
        eng = getattr(pipe.llm, "engine", None)
        if eng is not None:   # token-level instants (clones inherit it)
            eng.tracer = tracer
    monitor = ResourceMonitor(MonitorConfig(out_path=args.monitor_out)).start()
    monitor.add_gauge("db_live", lambda: pipe.db.stats()["live"])
    if hasattr(pipe.db, "gauges"):   # sharded backend: per-shard balance
        monitor.add_gauges(pipe.db.gauges())

    corpus = SyntheticCorpus(CorpusConfig(n_docs=args.docs))
    t0 = time.perf_counter()
    n_chunks = pipe.index_documents(corpus.all_documents())
    print(f"indexed {args.docs} docs -> {n_chunks} chunks "
          f"in {time.perf_counter() - t0:.1f}s")

    wcfg = WorkloadConfig(
        query_frac=1.0 - args.update_frac, update_frac=args.update_frac,
        distribution=args.distribution, n_requests=args.requests,
        seed=args.seed)
    doc = {"mode": args.mode, "elastic": elastic_on, "seed": args.seed,
           "device": args.device}
    executor = controller = None
    if args.mode == "sync":
        res = run_workload(pipe, corpus, wcfg, query_batch=args.batch)
        print(f"served {args.requests} requests: {res.qps:.2f} QPS")
        print("quality:", {k: round(v, 3) for k, v in res.quality.items()})
        doc["qps"] = res.qps
        doc["ops"] = {op: len(lat) for op, lat in res.latencies.items()}
        doc["quality"] = res.quality
    else:
        # build the kernels and warm every stage so neither pollutes the tail
        warm_up(pipe)
        scfg = ServingConfig(
            arrival=ArrivalConfig(
                mode=args.mode, process=args.arrival,
                target_qps=args.target_qps, n_requests=args.requests,
                concurrency=args.concurrency,
                ramp_period_s=args.ramp_period_s,
                ramp_amplitude=args.ramp_amplitude, seed=args.seed),
            policy=BatchPolicy(max_batch=args.batch,
                               max_wait_s=args.batch_timeout_ms / 1e3,
                               priority=args.priority),
            slo_ms=slo_ms, evaluate=True)
        if elastic_on:
            executor = ElasticExecutor(
                pipe, replicas=spec.stage_replicas(),
                batch_sizes=spec.stage_batch_sizes(),
                default_batch=args.batch,
                max_replicas=args.max_replicas
                or spec.autoscale.max_replicas,
                tracer=tracer)
            acfg = AutoscaleConfig.from_spec(
                spec.autoscale, base_nprobe=executor.knobs["nprobe"],
                base_rerank_k=executor.knobs["rerank_k"],
                base_max_new=executor.knobs.get("max_new", 0))
            acfg.max_replicas = executor.max_replicas
            acfg.slo_ms = slo_ms
            if args.autoscale_interval_ms > 0:
                acfg.interval_s = args.autoscale_interval_ms / 1e3
            controller = AutoscaleController(acfg, executor=executor)
        harness = ServingHarness(pipe, corpus, wcfg, scfg,
                                 executor=executor, tracer=tracer)
        monitor.add_gauges(harness.gauges())
        if controller is not None:
            controller.start()
        try:
            res = harness.run()
        finally:
            if controller is not None:
                controller.stop()
        s = res.summary
        if args.mode == "open":
            print(f"offered {s.get('offered_qps', 0.0):.2f} QPS "
                  f"({args.arrival}), achieved {s['achieved_qps']:.2f} QPS")
        else:
            print(f"closed-loop concurrency={args.concurrency}: "
                  f"achieved {s['achieved_qps']:.2f} QPS "
                  f"(peak in-flight {res.peak_in_flight})")
        # .get defaults: a query-free workload (--update-frac 1.0) has no
        # latency percentiles to report
        print(f"latency p50/p95/p99 (ms): {s.get('p50_latency_ms', 0.0):.1f} / "
              f"{s.get('p95_latency_ms', 0.0):.1f} / "
              f"{s.get('p99_latency_ms', 0.0):.1f}")
        print(f"queue wait p50/p95 (ms): {s.get('p50_queue_wait_ms', 0.0):.1f} / "
              f"{s.get('p95_queue_wait_ms', 0.0):.1f}; "
              f"mean batch {s.get('mean_batch_size', 1.0):.2f} "
              f"(peak queue depth {res.peak_queue_depth})")
        print(f"SLO {slo_ms:.0f} ms: attainment "
              f"{s.get('slo_attainment', 0.0):.3f}, goodput "
              f"{s.get('goodput_qps', 0.0):.2f} QPS")
        print("quality:", {k: round(v, 3) for k, v in res.quality.items()})
        doc["summary"] = s
        doc["quality"] = res.quality
        doc["ops"] = {}
        for rec in res.records:
            doc["ops"][rec.op] = doc["ops"].get(rec.op, 0) + 1
        if executor is not None:
            rows = [st.row() for st in executor.stats]
            doc["stage_report"] = rows
            doc["scaling_events"] = controller.event_dicts()
            doc["knob_timeline"] = controller.knob_timeline()
            doc["final_knobs"] = dict(executor.knobs)
            doc["mean_write_batch"] = (
                sum(executor.write_batches) / len(executor.write_batches)
                if executor.write_batches else 0.0)
            print(f"elastic: {len(controller.events)} scaling events, "
                  f"final knobs {executor.knobs}")
            for row in rows:
                print(f"  {row['stage']:12s} replicas {row['replicas']:.0f}  "
                      f"occupancy {row['occupancy']:.2f}  "
                      f"queue_depth_max {row['queue_depth_max']:.0f}  "
                      f"mean batch {row['mean_batch']:.1f}")

    if args.stage_pipeline:
        # replay the workload's query stream through the pipelined stage
        # graph: stage N on batch i+1 while stage N+1 runs batch i
        reqs = [r for r in WorkloadGenerator(wcfg, corpus).requests()
                if r.op == "query"]
        golds = [gold_chunks_for(pipe.db, r.gold_doc_id, r.answer)
                 for r in reqs]
        if tracer is not None:
            for st in pipe.stages:   # staged emits per-item spans itself
                st.tracer = None
        staged = StagedExecutor(pipe, default_batch=args.batch,
                                tracer=tracer)
        monitor.add_gauges(staged.gauges())
        pipe.traces.clear()
        sres = staged.run([r.question for r in reqs],
                          ground_truth=[r.answer for r in reqs],
                          gold_chunks=golds)
        print(f"stage-pipeline: {len(reqs)} queries at "
              f"{sres.throughput_qps:.2f} QPS (wall {sres.wall_s:.2f}s)")
        for row in sres.report():
            print(f"  {row['stage']:12s} busy {row['busy_s']:.3f}s  "
                  f"idle {row['idle_s']:.3f}s  stall {row['stall_s']:.3f}s  "
                  f"occupancy {row['occupancy']:.2f}  "
                  f"mean batch {row['mean_batch']:.1f}")
        quality = evaluate_traces(sres.traces, pipe.db)
        print("stage-pipeline quality:",
              {k: round(v, 3) for k, v in quality.items()})
        doc["stage_pipeline"] = {
            "throughput_qps": sres.throughput_qps, "wall_s": sres.wall_s,
            "report": sres.report(), "quality": quality}

    # generation metrics where the backend keeps them (ModelLLM); others
    # get an empty block, as in the reference's run document
    llm_stats = getattr(pipe.llm, "stats", None)
    gen_block = llm_stats.summary() if hasattr(llm_stats, "summary") else {}
    doc["gen"] = gen_block
    if gen_block:
        print("gen stats:", {k: round(v, 4) for k, v in gen_block.items()})
    eng = getattr(pipe.llm, "engine", None)
    if eng is not None:   # the engine's scheduling counts, clones included
        doc["engine"] = eng.counters.summary()
        print("gen engine:", {k: round(v, 3)
                              for k, v in doc["engine"].items()})
    print("stage breakdown (s):",
          {k: round(v, 3) for k, v in pipe.breakdown().items()})
    monitor.stop()
    if tracer is not None:
        # one unified timeline: monitor samples, stage occupancy, gen
        # stats and scaling events land next to the request spans
        registry.absorb_monitor(monitor)
        if gen_block:
            registry.absorb_gen_stats(gen_block, t=tracer.now())
        if executor is not None:
            registry.absorb_stage_rows([st.row() for st in executor.stats],
                                       t=tracer.now())
            registry.absorb_scale_events(controller.event_dicts())
        write_trace(args.trace_out, tracer, registry)
        doc["trace_out"] = args.trace_out
    doc["stage_breakdown"] = pipe.breakdown()
    doc["db"] = pipe.db_stats()
    if args.json_out:
        write_json(args.json_out, doc)
    return doc


if __name__ == "__main__":
    main()
