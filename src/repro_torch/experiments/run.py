"""Run every ported experiment (one per paper table/figure) and print CSV.

``PYTHONPATH=src python -m repro_torch.experiments.run [--scale 1.0]
[--only name] [--device cuda|cpu]``
"""
from __future__ import annotations

import argparse
import time
import traceback

from repro_torch import resolve_device
from repro_torch.experiments import (accuracy_eval, chaos,
                                     elastic_scaling, fused_retrieve,
                                     gen_engine, index_schemes,
                                     indexing_breakdown, monitor_overhead,
                                     overhead, query_breakdown,
                                     resource_limits, resource_utilization,
                                     scenarios, sensitivity, serving,
                                     sharded_retrieval, stage_pipeline,
                                     update_workload)
from repro_torch.experiments.common import emit

MODULES = {
    "query_breakdown": query_breakdown,       # Fig. 5
    "indexing_breakdown": indexing_breakdown,  # Fig. 6
    "resource_utilization": resource_utilization,  # Fig. 7
    "accuracy_eval": accuracy_eval,           # Fig. 8
    "update_workload": update_workload,       # Fig. 9
    "resource_limits": resource_limits,       # Fig. 10
    "sensitivity": sensitivity,               # Fig. 11
    "index_schemes": index_schemes,           # Fig. 12
    "monitor_overhead": monitor_overhead,     # §5.8
    "serving": serving,                       # open/closed-loop QPS sweep
    "stage_pipeline": stage_pipeline,         # lock-step vs pipelined stages
    "elastic_scaling": elastic_scaling,       # static vs elastic + knob ladder
    "gen_engine": gen_engine,                 # lock-step vs continuous batching
    "scenarios": scenarios,                   # named scenario suite (sim mode)
    "chaos": chaos,                           # fault injection + recovery
    "sharded_retrieval": sharded_retrieval,   # corpus scaling at flat p99
    "overhead": overhead,                     # tracing on/off A-B gate
    "fused_retrieve": fused_retrieve,         # fused-kernel retrieve gate
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("benchmark,metric,value")
    failures = []
    for name, mod in MODULES.items():
        if args.only and name != args.only:
            continue
        t0 = time.perf_counter()
        try:
            rows = mod.run(args.scale, device)
            emit(rows)
            print(f"{name},wall_s,{time.perf_counter() - t0:.2f}")
        except Exception:
            traceback.print_exc()
            failures.append(name)
    if failures:
        print("FAILED:", ",".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
