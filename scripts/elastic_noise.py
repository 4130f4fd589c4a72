#!/usr/bin/env python3
"""How much of the serving studies' timing verdicts is noise, on the card.

    python3 scripts/elastic_noise.py [--pairs 10] [--overhead 2]

From the root of a checkout, on one card. Prints the card's name and
power limit, then:

* the first device operations of a new thread (a host-to-device copy, an
  add, a matrix product, a device-to-host copy, then a vector-DB search
  twice), each in ms, for two threads one after the other;
* ``--pairs`` pairs of ``elastic_scaling`` serves (the study's sizes at
  scale 1.0: ``burst_tolerance``, 48 documents, 160 requests at 80 QPS)
  of each kind, static then elastic and static then static, in turns:
  each run's goodput and p99, the garbage collector's pauses over 2 ms
  inside it, and the verdict of ``elastic_scaling.check``'s timing rule
  (the second run not worse than the first on goodput and p99 both);
  the count of pairs that break the rule, by kind;
* ``--overhead`` runs of ``overhead.measure`` at its ``--smoke`` size
  (0.5, 3 interleaved rounds): the throughput and p99 ratios of tracing
  on over off, and the 3 % budget's verdict.

The last line is one JSON object with the counts. Exits with another code
than 0 without a card.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

SLOW_GC_MS = 2.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--overhead", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: elastic_noise.py needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    from repro_torch.experiments import elastic_scaling as es
    from repro_torch.experiments import overhead
    from repro_torch.serving import harness

    pipe, _ = es._fresh_pipeline(48, 0, "cuda")
    qv = pipe.embedder.embed([f"query {i}" for i in range(8)])
    pipe.db.search(qv, 8)
    torch.cuda.synchronize()

    def first_ops(out):
        def timed(name, fn):
            t0 = time.perf_counter()
            result = fn()
            out.append((name, time.perf_counter() - t0))
            return result

        y = timed("h2d", lambda: torch.as_tensor(qv).to("cuda"))
        timed("add", lambda: y + 1)
        timed("matmul", lambda: y @ y.T)
        timed("d2h", lambda: y.cpu())
        timed("search", lambda: pipe.db.search(qv, 8))
        timed("search again", lambda: pipe.db.search(qv, 8))

    for _ in range(2):
        out = []
        thread = threading.Thread(target=first_ops, args=(out,))
        thread.start()
        thread.join()
        print("a new thread's first operations, ms: " + ", ".join(
            f"{k} {1e3 * v:.3f}" for k, v in out), flush=True)

    pauses, start = [], {}

    def on_gc(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        else:
            pauses.append(1e3 * (time.perf_counter() - start["t"]))

    run = harness.ServingHarness.run

    def run_counting_pauses(self):
        pauses.clear()
        return run(self)

    gc.callbacks.append(on_gc)
    harness.ServingHarness.run = run_counting_pauses
    broken = {"static-elastic": 0, "static-static": 0}
    try:
        for i in range(2 * args.pairs):
            kind = ("static-elastic", "static-static")[i % 2]
            docs = []
            for mode in kind.split("-"):
                docs.append(es._serve(48, 160, 80.0, 0, mode, "cuda"))
                docs[-1]["slow_gc_ms"] = [round(p, 1) for p in pauses
                                          if p > SLOW_GC_MS]
            first, second = docs
            bad = es.check({"equivalent_outputs": True, "static": first,
                            "elastic": dict(second,
                                            deterministic_replay=True)})
            broken[kind] += bool(bad)
            print(f"{kind}: " + "; ".join(
                f"goodput {d['goodput_qps']:.4f} QPS, p99 {d['p99_ms']:.2f} "
                f"ms, gc pauses > {SLOW_GC_MS} ms {d['slow_gc_ms']}"
                for d in docs) + f": {'BROKEN' if bad else 'not worse'}",
                flush=True)
    finally:
        gc.callbacks.remove(on_gc)
        harness.ServingHarness.run = run
    over = []
    for _ in range(args.overhead):
        m = overhead.measure(0.5, 3, "cuda")
        over.append((m["tput_ratio"], m["p99_ratio"],
                     bool(overhead.violations(m))))
        print(f"overhead at 0.5, 3 rounds: throughput ratio "
              f"{m['tput_ratio']:.4f}, p99 ratio {m['p99_ratio']:.4f}: "
              f"{overhead.violations(m) or 'within 3 %'}", flush=True)
    print(json.dumps({"pairs": args.pairs, "broken": broken,
                      "overhead": over}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
