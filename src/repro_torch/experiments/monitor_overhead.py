"""Paper §5.8: profiling overhead: the same workload with and without the
monitor; reports the latency delta and the monitor's own resource cost
(the port of ``benchmarks/monitor_overhead.py``)."""
from __future__ import annotations

import time

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus
from repro_torch.monitor.monitor import MonitorConfig, ResourceMonitor
from repro_torch.workload.generator import WorkloadConfig
from repro_torch.workload.runner import run_workload


def _run_once(with_monitor: bool, n_docs: int, n_req: int, device):
    corpus = make_corpus(n_docs, seed=9)
    mon = None
    if with_monitor:
        mon = ResourceMonitor(MonitorConfig(interval_s=0.05)).start()
    try:
        pipe = build_pipeline(corpus, device=device)
        if mon:
            mon.add_gauge("db_live", lambda: pipe.db.stats()["live"])
        t0 = time.perf_counter()
        run_workload(pipe, corpus, WorkloadConfig(
            query_frac=0.8, update_frac=0.2, n_requests=n_req, seed=10),
            query_batch=4, evaluate=False)
        wall = time.perf_counter() - t0
        probe = mon.probe_cost_s if mon else 0.0
    finally:
        if mon:
            mon.stop()
    return wall, probe


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    n_docs = max(int(32 * scale), 8)
    n_req = max(int(40 * scale), 12)
    base, _ = _run_once(False, n_docs, n_req, device)
    mon, probe = _run_once(True, n_docs, n_req, device)
    return [{
        "bench": "monitor_overhead",
        "baseline_s": base,
        "monitored_s": mon,
        "overhead_frac": max(mon - base, 0.0) / base if base else 0.0,
        "probe_cost_s": probe,
    }]


if __name__ == "__main__":
    emit(run())
