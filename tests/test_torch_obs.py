"""The port's observability layer (``repro_torch.obs``) against the JAX
package's, on the CPU: the tracer, the metrics registry, the exporters and
the latency decomposition give the same documents from the same records,
and ``--trace-out`` writes a valid Chrome trace on the lock-step, staged and
elastic paths."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import obs as jobs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPEC = os.path.join(ROOT, "src", "repro_torch", "specs", "fused_ivf.json")


def _record(mod, seed):
    """The same seeded spans, instants and metrics into one package's
    tracer and registry, on a virtual clock."""
    rng = np.random.default_rng(seed)
    clock = mod.VirtualClock()
    tr = mod.Tracer(clock=clock)
    reg = mod.MetricsRegistry(clock=clock)
    for i in range(60):
        t0 = float(rng.uniform(0, 2))
        stage = ["query_embed", "retrieval", "rerank", "generation"][i % 4]
        tr.add_span(stage, t0, t0 + float(rng.exponential(0.01)),
                    cat="service", tid=f"{stage}/r{i % 2}", req=i, n=2)
        if i % 7 == 0:
            tr.instant("requeue", t=t0, cat="retry", tid=stage, req=i,
                       attempt=1)
        clock.set(t0)
        with tr.span("writer.apply", cat="writer", tid="writer", n=i):
            clock.set(t0 + 0.002)
        reg.counter_add("served", 1.0)
        reg.gauge_set("serving_queue_depth", float(i % 5))
        reg.observe("latency_ms", float(rng.exponential(20)))
    reg.absorb_stage_rows([{"stage": "retrieval", "busy_s": 1.0,
                            "occupancy": 0.5}], t=0.5)
    reg.absorb_gen_stats({"ttft_p50_s": 0.01}, t=0.6)
    reg.absorb_scale_events([{"t_s": 0.7, "kind": "replicas",
                              "stage": "retrieval", "prev": 1, "new": 2,
                              "reason": "backlog"}])
    return tr, reg


@pytest.mark.parametrize("seed", [0, 3])
def test_exporters_match_reference(seed, tmp_path):
    jtr, jreg = _record(jobs, seed)
    ttr, treg = _record(obs, seed)
    doc = obs.chrome_trace_doc(ttr, treg)
    assert json.dumps(doc) == json.dumps(jobs.chrome_trace_doc(jtr, jreg))
    assert obs.validate_chrome_trace(doc) == []
    jobs.write_jsonl(str(tmp_path / "j.jsonl"), jtr, jreg)
    obs.write_jsonl(str(tmp_path / "t.jsonl"), ttr, treg)
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert treg.histogram_summary("latency_ms") == \
        jreg.histogram_summary("latency_ms")
    assert treg.counter_value("served") == 60.0


def test_validate_chrome_trace_matches_reference_on_broken_docs():
    bad = [None, {}, {"traceEvents": []},
           {"traceEvents": [{"name": "a", "ph": "X", "ts": -1, "pid": 1}]},
           {"traceEvents": [{"ph": "Q"}, 3, {"name": "b", "ph": "i"}]}]
    for doc in bad:
        got = obs.validate_chrome_trace(doc)
        assert got and got == jobs.validate_chrome_trace(doc)


def test_decomposition_matches_reference():
    rng = np.random.default_rng(4)
    rows = []
    for _ in range(50):
        stages = {s: float(rng.exponential(0.005))
                  for s in obs.STAGE_ORDER}
        rows.append((sum(stages.values()) + float(rng.exponential(0.01)),
                     stages))
    assert obs.decomposition_summary(rows) == \
        jobs.decomposition_summary(rows)
    assert obs.request_components(0.001, {"retrieval": 0.002}) == \
        jobs.request_components(0.001, {"retrieval": 0.002})


@pytest.mark.parametrize("flags", [
    ["--mode", "sync"],
    ["--mode", "sync", "--stage-pipeline"],
    ["--mode", "open", "--elastic", "--target-qps", "400"],
], ids=["lockstep", "staged", "elastic"])
def test_trace_out_writes_a_valid_trace(flags, tmp_path):
    """``--trace-out`` on each executor path: a valid Chrome trace and its
    ``.jsonl`` sibling, with the spans each path records."""
    path = tmp_path / "trace.json"
    serve.main(["--config", SPEC, "--device", "cpu", "--docs", "16",
                "--requests", "20", "--trace-out", str(path), *flags])
    doc = json.loads(path.read_text())
    assert obs.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"query_embed", "retrieval", "rerank", "generation"} <= names
    if "--elastic" in flags:
        assert {"request", "retrieval.queue", "retrieval.coalesce"} <= names
    if "--stage-pipeline" in flags:
        assert "retrieval.queue" in names
    lines = (tmp_path / "trace.jsonl").read_text().splitlines()
    assert lines and all(json.loads(line)["type"] in
                         ("span", "instant", "metric") for line in lines)
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          str(path)], capture_output=True, text=True,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout


def test_stopped_monitor_lets_its_gauges_go():
    """A stopped ResourceMonitor holds no process-wide reference (atexit,
    ``sys.excepthook``), so what its gauges capture (a pipeline, a model
    on the card) is freed once the caller drops it: a process that serves
    several times does not keep every run's model."""
    import gc
    import weakref

    from repro_torch.monitor.monitor import MonitorConfig, ResourceMonitor

    class Held:
        live = 1.0

    held = Held()
    ref = weakref.ref(held)
    hook = sys.excepthook
    mon = ResourceMonitor(MonitorConfig(interval_s=0.01)).start()
    mon.add_gauge("db_live", lambda h=held: h.live)
    mon.stop()
    assert sys.excepthook is hook
    del mon, held
    gc.collect()
    assert ref() is None
