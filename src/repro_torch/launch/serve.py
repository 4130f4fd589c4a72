"""Serving entry point of the port:
``python -m repro_torch.launch.serve --config src/repro_torch/specs/fused_ivf.json``.

Builds the pipeline from a ``PipelineSpec`` JSON through the port's registry,
indexes a synthetic corpus and replays a seeded workload stream through it
(``--mode sync``, the offline replay of ``repro.launch.serve``). Every
component runs on ``--device`` (default ``cuda``). ``--arch`` (with
``--smoke`` and ``--max-new``) puts a ``ModelLLM`` of that architecture in
the generator slot as the reference's flags do, ``--config`` giving the
other slots. The JAX package's other modes and flags are not ported yet;
they fail naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec, StageSpec
from repro_torch.monitor.monitor import MonitorConfig, ResourceMonitor
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
from repro_torch.workload.generator import WorkloadConfig
from repro_torch.workload.runner import run_workload

# flags of repro.launch.serve that the port does not take yet -> the item
# of ROADMAP.md queue 1 that ports them
NOT_PORTED = {
    "--scenario": "queue 1 item 5 (serving modes, scenarios, obs)",
    "--trace-out": "queue 1 item 5 (serving modes, scenarios, obs)",
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve the RAG pipeline of the PyTorch/CUDA port.")
    ap.add_argument("--config", required=True, help="PipelineSpec JSON")
    ap.add_argument("--arch", default="",
                    help="serve a ModelLLM of this architecture in the llm "
                         "slot (dense family)")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="sync",
                    help="only 'sync' is ported (open/closed: ROADMAP.md "
                         "queue 1 item 5)")
    ap.add_argument("--device", default="cuda",
                    help="device of every component (cuda or cpu)")
    ap.add_argument("--monitor-out", default="")
    ap.add_argument("--json-out", default="",
                    help="write the run document (qps, quality, stage "
                         "breakdown, DB stats) as JSON")
    for flag in NOT_PORTED:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet: ROADMAP.md {item}")
    if args.mode != "sync":
        ap.error(f"--mode {args.mode} is not ported yet: ROADMAP.md queue 1 "
                 f"item 5 (the open/closed/elastic/staged serving modes)")

    spec = PipelineSpec.from_file(args.config)
    if args.arch:
        # the reference's flag mapping (repro.launch.serve.spec_from_args):
        # the serving driver runs its generator with a short prompt
        spec.llm = StageSpec("model", {
            "arch": args.arch, "smoke": args.smoke, "batch_size": args.batch,
            "max_new": args.max_new, "max_prompt": 128},
            batch_size=args.batch)
    pipe = build(spec, device=args.device)
    monitor = ResourceMonitor(MonitorConfig(out_path=args.monitor_out)).start()
    monitor.add_gauge("db_live", lambda: pipe.db.stats()["live"])

    corpus = SyntheticCorpus(CorpusConfig(n_docs=args.docs))
    t0 = time.perf_counter()
    n_chunks = pipe.index_documents(corpus.all_documents())
    print(f"indexed {args.docs} docs -> {n_chunks} chunks "
          f"in {time.perf_counter() - t0:.1f}s")

    wcfg = WorkloadConfig(
        query_frac=1.0 - args.update_frac, update_frac=args.update_frac,
        distribution=args.distribution, n_requests=args.requests,
        seed=args.seed)
    res = run_workload(pipe, corpus, wcfg, query_batch=args.batch)
    monitor.stop()
    print(f"served {args.requests} requests: {res.qps:.2f} QPS")
    print("quality:", {k: round(v, 3) for k, v in res.quality.items()})
    # generation metrics where the backend keeps them (ModelLLM); others
    # get an empty block, as in the reference's run document
    llm_stats = getattr(pipe.llm, "stats", None)
    gen_block = llm_stats.summary() if hasattr(llm_stats, "summary") else {}
    if gen_block:
        print("gen stats:", {k: round(v, 4) for k, v in gen_block.items()})
    print("stage breakdown (s):",
          {k: round(v, 3) for k, v in pipe.breakdown().items()})
    doc = {"mode": args.mode, "seed": args.seed, "device": args.device,
           "qps": res.qps, "ops": {op: len(lat) for op, lat in
                                   res.latencies.items()},
           "quality": res.quality, "gen": gen_block,
           "stage_breakdown": pipe.breakdown(), "db": pipe.db_stats()}
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"wrote {args.json_out}")
    return doc


if __name__ == "__main__":
    main()
