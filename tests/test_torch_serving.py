"""The port's serving layer against the JAX package's, on the CPU.

The arrival process, the batcher, the latency accountant, the autoscale
controller and the fault spec are plain Python over numpy in both packages:
the same inputs must give the same outputs, bit for bit. ``ModelLLM``'s
replica surface (``clone``, ``set_max_new``, shared ``GenStats``), the
kernel launch counters under threads, and every serve mode of
``repro_torch.launch.serve`` with ``--device cpu`` are held here too. The
one ``cuda`` test drives the open-loop and elastic paths on the card.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.spec import AutoscaleSpec as JAutoscaleSpec  # noqa: E402
from repro.scenarios import get_scenario as jget_scenario  # noqa: E402
from repro.scenarios import scenario_names as jscenario_names  # noqa: E402
from repro.serving import accounting as jacc  # noqa: E402
from repro.serving import autoscale as jauto  # noqa: E402
from repro.serving.arrival import ArrivalConfig as JArrivalConfig  # noqa: E402
from repro.serving.arrival import arrival_times as jarrival_times  # noqa: E402
from repro.serving.batcher import BatchPolicy as JBatchPolicy  # noqa: E402
from repro.serving.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serving.batcher import Submission as JSubmission  # noqa: E402
from repro.serving.faults import FaultSpec as JFaultSpec  # noqa: E402
from repro.workload.corpus import CorpusConfig as JCorpusConfig  # noqa: E402
from repro.workload.corpus import SyntheticCorpus as JCorpus  # noqa: E402
from repro.workload.generator import WorkloadConfig as JWConfig  # noqa: E402
from repro.workload.generator import WorkloadGenerator as JGen  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.generator import GenStats, ModelLLM  # noqa: E402
from repro_torch.core.spec import AutoscaleSpec, PipelineSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.scenarios import (ScenarioRunner, get_scenario,  # noqa: E402
                                   golden_variant, scenario_names)
from repro_torch.serving import accounting as tacc  # noqa: E402
from repro_torch.serving import autoscale as tauto  # noqa: E402
from repro_torch.serving.arrival import ArrivalConfig, arrival_times  # noqa: E402
from repro_torch.serving.batcher import (BatchPolicy,  # noqa: E402
                                         ContinuousBatcher, Submission)
from repro_torch.serving.elastic import ElasticExecutor  # noqa: E402
from repro_torch.serving.faults import FaultEvent, FaultSpec  # noqa: E402
from repro_torch.serving.harness import (ServingConfig,  # noqa: E402
                                         ServingHarness)
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus  # noqa: E402
from repro_torch.workload.generator import (WorkloadConfig,  # noqa: E402
                                            WorkloadGenerator)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPEC = os.path.join(ROOT, "src", "repro_torch", "specs", "fused_ivf.json")
SHARDED_SPEC = os.path.join(ROOT, "src", "repro_torch", "specs",
                            "sharded_ivf.json")
PROCESSES = ("poisson", "bursty", "uniform", "diurnal")
STAGES = ["query_embed", "retrieval", "rerank", "generation"]


# -- launch counters -----------------------------------------------------------


def _run_threads(threads):
    """Start and join ``threads`` with a short switch interval, so that a
    read-modify-write without its lock would lose updates."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


def test_launch_counts_lose_nothing_under_threads():
    """8 threads x 1,000 increments give exactly 8,000 on every counter
    (the wrappers count from replica worker threads)."""
    ops.reset_launch_counts()

    def work():
        for _ in range(1000):
            for name in ops.KERNELS:
                ops.count_launch(name)

    _run_threads([threading.Thread(target=work) for _ in range(8)])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 8000)
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# -- arrivals, batcher, accountant -------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("process", PROCESSES)
def test_arrival_times_bit_equal_to_reference(process, seed):
    kw = dict(process=process, target_qps=37.5, n_requests=300,
              burst_cycle_s=1.5, burst_duty=0.3, ramp_period_s=3.0,
              ramp_amplitude=0.7, seed=seed)
    want = jarrival_times(JArrivalConfig(**kw))
    got = arrival_times(ArrivalConfig(**kw))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _drain(batcher_cls, policy_cls, sub_cls, requests, priority):
    b = batcher_cls(policy_cls(max_batch=4, max_wait_s=10.0,
                               priority=priority))
    for req in requests:
        b.submit(sub_cls(request=req, record=None))
    b.close()
    order = []
    while True:
        batch = b.get_batch()
        if batch is None:
            return order
        order.append([(s.request.op, s.request.doc_id, s.request.question)
                      for s in batch])


@pytest.mark.parametrize("priority", ["fifo", "query_first",
                                      "mutation_first"])
def test_batcher_orders_equal_reference(priority):
    """One seeded mixed stream through both batchers: the same batches in
    the same order under every read/write priority."""
    kw = dict(query_frac=0.6, insert_frac=0.1, update_frac=0.2,
              removal_frac=0.1, distribution="zipfian", n_requests=80,
              seed=3)
    jreqs = list(JGen(JWConfig(**kw), JCorpus(JCorpusConfig(n_docs=24)))
                 .requests())
    treqs = list(WorkloadGenerator(WorkloadConfig(**kw), SyntheticCorpus(
        CorpusConfig(n_docs=24))).requests())
    want = _drain(JBatcher, JBatchPolicy, JSubmission, jreqs, priority)
    got = _drain(ContinuousBatcher, BatchPolicy, Submission, treqs,
                 priority)
    assert got == want
    assert {op for batch in got for op, _, _ in batch} == {
        "query", "insert", "update", "removal"}


def _records(mod, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(200):
        arr = float(rng.uniform(0, 5))
        start = arr + float(rng.exponential(0.03))
        end = start + float(rng.exponential(0.08))
        op = ["query", "query", "query", "update", "insert"][i % 5]
        recs.append(mod.RequestRecord(req_id=i, op=op, arrival_s=arr,
                                      start_s=start, end_s=end,
                                      ok=bool(rng.random() > 0.05)))
    return recs


@pytest.mark.parametrize("slo_ms", [None, 60.0, 120.0])
def test_accountant_matches_reference(slo_ms):
    """Percentiles, SLO attainment and goodput on the same records."""
    jac, tac = jacc.LatencyAccountant(slo_ms), tacc.LatencyAccountant(slo_ms)
    for jr, tr in zip(_records(jacc, 5), _records(tacc, 5)):
        jac.observe(jr)
        tac.observe(tr)
    want, got = jac.summary(offered_qps=40.0), tac.summary(offered_qps=40.0)
    assert got == want
    if slo_ms is not None:
        assert 0.0 < got["slo_attainment"] < 1.0 and got["goodput_qps"] > 0
    xs = [r.latency_s for r in _records(tacc, 9)]
    for q in (0, 1, 50, 95, 99, 100):
        assert tacc.percentile(xs, q) == jacc.percentile(xs, q)
        assert tacc.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), abs=1e-12)


# -- autoscale controller ----------------------------------------------------


def _snapshots(mod, seed, n=40, stragglers=False):
    """A seeded random walk of cumulative stage counters, backlogs, tails
    and (optionally) flagged stragglers."""
    rng = np.random.default_rng(seed)
    busy, idle = np.zeros(4), np.zeros(4)
    reps, batch = [1, 1, 1, 1], [8, 8, 8, 8]
    out = []
    for i in range(n):
        busy += rng.uniform(0, 0.2, 4)
        idle += rng.uniform(0, 0.2, 4)
        depth = rng.integers(0, 30, 4) * (rng.random(4) < 0.5)
        reps = [int(r) for r in rng.integers(1, 5, 4)]
        strag = ([("retrieval", int(rng.integers(0, 3)))]
                 if stragglers and rng.random() < 0.2 else [])
        out.append(mod.Snapshot(
            t_s=0.2 * i, p95_ms=float(rng.uniform(20, 400)),
            n_completed=10 * i, stragglers=strag,
            stages=[mod.StageSample(name=s, busy_s=float(busy[j]),
                                    idle_s=float(idle[j]), stall_s=0.0,
                                    queue_depth=float(depth[j]),
                                    replicas=reps[j], batch_size=batch[j])
                    for j, s in enumerate(STAGES)]))
    return out


class _RecordingExecutor:
    """Stands in for an ElasticExecutor: logs every control call."""

    def __init__(self, knobs):
        self.knobs = dict(knobs)
        self.calls = []

    def set_replicas(self, stage, n):
        self.calls.append(("set_replicas", stage, n))

    def set_batch_size(self, stage, bs):
        self.calls.append(("set_batch_size", stage, bs))

    def apply_knobs(self, **kw):
        self.calls.append(("apply_knobs", sorted(kw.items())))

    def retire_replica(self, stage, rid):
        self.calls.append(("retire_replica", stage, rid))


@pytest.mark.parametrize("case", [
    "two-column", "three-column", "stragglers", "tight-slo", "max2"])
def test_autoscale_decisions_match_reference(case):
    """The same snapshot sequence through both controllers, each driving a
    recording executor: the same events, control calls, knob timeline and
    replay."""
    knobs = {"nprobe": 8, "rerank_k": 3,
             "max_new": 16 if case == "three-column" else 0}
    kw = dict(max_replicas=2 if case == "max2" else 4,
              slo_ms=60.0 if case == "tight-slo" else 150.0)
    runs = []
    for mod in (jauto, tauto):
        ex = _RecordingExecutor(knobs)
        ctl = mod.AutoscaleController(mod.AutoscaleConfig(**kw), executor=ex)
        for snap in _snapshots(mod, seed=len(case),
                               stragglers=case == "stragglers"):
            ctl.step(snap)
        runs.append((ctl.event_dicts(), ex.calls, ctl.knob_timeline(),
                     [e.to_dict() for e in ctl.replay_events()],
                     ctl.cfg.ladder))
    assert runs[1] == runs[0]
    events = runs[1][0]
    assert len(events) > 5 and {e["kind"] for e in events} >= {"replicas",
                                                               "knob"}
    if case == "stragglers":
        assert any(e["kind"] == "retire" for e in events)


def _snap(mod, t, busy=None, idle=None, depth=None, replicas=None,
          batch=None, p95=0.0):
    """The reference's test snapshot builder: per-stage lists in STAGES
    order (tests/test_autoscale.py)."""
    n = len(STAGES)
    busy, idle = busy or [0.0] * n, idle or [0.0] * n
    depth, replicas = depth or [0.0] * n, replicas or [1] * n
    batch = batch or [8] * n
    return mod.Snapshot(t_s=t, p95_ms=p95, stages=[
        mod.StageSample(name=s, busy_s=busy[i], idle_s=idle[i], stall_s=0.0,
                        queue_depth=depth[i], replicas=replicas[i],
                        batch_size=batch[i]) for i, s in enumerate(STAGES)])


# the reference's controller tests (tests/test_autoscale.py): config and
# snapshot sequence, as (config kwargs, ladder args, [snapshot kwargs])
CANNED = {
    "scale-up": ({"max_replicas": 4}, None, [
        dict(t=0.0), dict(t=0.2, busy=[0.0, 0.2, 0.0, 0.0],
                          depth=[0, 20, 0, 0])]),
    "scale-down": ({}, None, [
        dict(t=0.0), dict(t=0.2, busy=[0.0, 0.2, 0.0, 0.0],
                          idle=[0.0, 0.0, 0.0, 0.2], depth=[0, 20, 0, 0],
                          replicas=[1, 1, 1, 3])]),
    "batch": ({"max_replicas": 2, "max_batch": 32}, None, [
        dict(t=0.0), dict(t=0.2, busy=[0.0, 0.2, 0.0, 0.0],
                          depth=[0, 30, 0, 0], replicas=[1, 2, 1, 1]),
        dict(t=0.4, idle=[0.1] * 4, replicas=[1, 2, 1, 1],
             batch=[8, 16, 8, 8]),
        dict(t=0.6, idle=[0.1] * 4, replicas=[1, 2, 1, 1],
             batch=[8, 16, 8, 8])]),
    "ladder": ({"slo_ms": 100.0, "cooldown_steps": 1,
                "knob_headroom": 0.5}, (8, 3), [
        dict(t=0.2 * i, p95=p) for i, p in
        enumerate([0.0, 250.0, 250.0, 250.0, 30.0, 30.0])]),
    "three-column": ({"slo_ms": 100.0, "cooldown_steps": 0}, (4, 2, 8), [
        dict(t=0.2 * i, p95=p) for i, p in
        enumerate([250.0] * 10 + [10.0] * 10)]),
}


@pytest.mark.parametrize("case", sorted(CANNED))
def test_autoscale_matches_reference_on_its_test_inputs(case):
    kw, ladder_args, seq = CANNED[case]
    runs = []
    for mod in (jauto, tauto):
        cfg = mod.AutoscaleConfig(**kw, ladder=mod.default_ladder(
            *ladder_args) if ladder_args else [])
        ctl = mod.AutoscaleController(cfg)
        for snap_kw in seq:
            ctl.step(_snap(mod, **snap_kw))
        runs.append((ctl.event_dicts(), ctl.knob_timeline(), ctl.level))
    assert runs[1] == runs[0] and runs[1][0]


def test_autoscale_config_from_spec_matches_reference():
    for ladder in ([], [[8, 3], [4, 2], [1, 1]]):
        d = {"enabled": True, "max_replicas": 3, "interval_ms": 50.0,
             "slo_ms": 120.0, "max_batch": 16, "ladder": ladder}
        want = jauto.AutoscaleConfig.from_spec(
            JAutoscaleSpec.from_dict(d), base_nprobe=8, base_rerank_k=3,
            base_max_new=16)
        got = tauto.AutoscaleConfig.from_spec(
            AutoscaleSpec.from_dict(d), base_nprobe=8, base_rerank_k=3,
            base_max_new=16)
        assert got.__dict__ == want.__dict__
    assert tauto.default_ladder(16, 4, 12) == jauto.default_ladder(16, 4, 12)


# -- specs -------------------------------------------------------------------


def test_fault_spec_json_roundtrips_and_matches_reference():
    spec = FaultSpec(events=[
        FaultEvent(t_s=0.25, kind="replica_kill", stage="retrieval",
                   replica=1),
        FaultEvent(t_s=0.5, kind="replica_stall", stage="generation",
                   factor=3.0, duration_s=0.4),
        FaultEvent(t_s=1.0, kind="writer_stall", duration_s=0.2)],
        max_retries=1, respawn=False, respawn_delay_s=0.1, detect=True,
        straggler_tolerance=1.7, straggler_window=8)
    back = FaultSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert back == spec
    assert JFaultSpec.from_dict(spec.to_dict()).to_dict() == spec.to_dict()
    with pytest.raises(ValueError, match="unknown FaultSpec keys"):
        FaultSpec.from_dict({**spec.to_dict(), "bogus": 1})


def test_scenario_catalog_matches_reference():
    """Same names and, scenario by scenario, the same declarative spec
    (shard_scale included, on the port's sharded DB: ``--scenario list``
    reads the same)."""
    assert scenario_names() == jscenario_names()
    for name in scenario_names():
        got = json.loads(json.dumps(get_scenario(name).to_dict()).replace(
            '"torch_sharded"', '"sharded"'))   # the port's sharded DB
        assert got == jget_scenario(name).to_dict(), name
    assert get_scenario("shard_scale").pipeline["vectordb"][
        "component"] == "torch_sharded"


def test_pipeline_spec_merged_deep_merges_options():
    base = PipelineSpec.from_file(SPEC)
    out = base.merged({"vectordb": {"replicas": 2,
                                    "options": {"nprobe": 2}},
                       "retrieve_k": 5})
    assert out.vectordb.replicas == 2 and out.retrieve_k == 5
    assert out.vectordb.options == {**base.vectordb.options, "nprobe": 2}
    assert out.vectordb.component == base.vectordb.component
    assert out.stage_replicas()["retrieval"] == 2
    assert PipelineSpec.from_json(out.to_json()) == out


# -- ModelLLM replicas ---------------------------------------------------------


def test_model_llm_clone_shares_weights_and_stats():
    llm = ModelLLM(configs.get_smoke("llama3_8b"), max_prompt=32, max_new=6,
                   batch_size=2, device="cpu")
    twin = llm.clone()
    params = dict(llm.model.named_parameters())
    twin_params = dict(twin.model.named_parameters())
    assert params and params.keys() == twin_params.keys()
    for name, p in params.items():
        assert twin_params[name].data_ptr() == p.data_ptr(), name
    assert twin.stats is llm.stats
    assert twin.set_max_new(100) == 6 and twin.set_max_new(0) == 1
    assert twin.set_max_new(3) == 3 and llm.max_new == 6
    out = twin.generate(["what is x"], [[]])
    assert len(out[0].split()) == 3
    assert llm.stats.n_requests == 1 and llm.stats.tokens_out == 3
    shared = GenStats()
    assert ModelLLM(llm.cfg, max_prompt=32, max_new=2, batch_size=1,
                    device="cpu", model=llm.model,
                    stats=shared).stats is shared


def test_gen_stats_merge_loses_nothing_under_threads():
    total = GenStats()
    parts = [GenStats() for _ in range(8)]

    def work(st, i):
        for j in range(500):
            st.record(0.001 * i, 0.0001 * j, 2)
            total.record(0.0, 0.0, 1)

    _run_threads([threading.Thread(target=work, args=(st, i))
                  for i, st in enumerate(parts)])
    _run_threads([threading.Thread(target=total.merge, args=(st,))
                  for st in parts])
    assert total.n_requests == 8 * 500 * 2
    assert len(total.ttft_s) == len(total.tpot_s) == 8000
    assert total.tokens_out == 4000 + 8000


# -- executors and the serve CLI ---------------------------------------------


def test_entry_points_need_cuda_by_default(monkeypatch):
    """The harness's spec path and the scenario runner build on the card
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = SyntheticCorpus(CorpusConfig(n_docs=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingHarness(PipelineSpec.from_file(SPEC), corpus,
                       WorkloadConfig(n_requests=4), ServingConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScenarioRunner(golden_variant("steady")).replay_outputs("lockstep")


def test_elastic_requeues_a_failed_batch_without_failing_it():
    """A stage exception requeues the batch's items within the retry
    budget: every request completes, outputs equal the lock-step run's."""
    from repro_torch.core.registry import build
    pipe = build(PipelineSpec.from_file(SPEC), device="cpu")
    corpus = SyntheticCorpus(CorpusConfig(n_docs=16))
    pipe.index_documents(corpus.all_documents())
    qs = [f"what is the color of {d}" for d in ("alpha", "beta", "gamma")]
    want = [t.answer for t in pipe.query(qs)]
    rerank = pipe.stages[2]
    orig, failed = rerank._apply, []

    def flaky(batch):
        if not failed:
            failed.append(len(batch))
            raise RuntimeError("injected")
        return orig(batch)

    rerank._apply = flaky
    res = ElasticExecutor(pipe, replicas={"retrieval": 2},
                          default_batch=2).run(qs)
    assert failed and res.n_retried == failed[0] and res.n_failed == 0
    assert [t.answer for t in res.traces] == want
    assert max(t.n_attempts for t in res.traces) == 2


@pytest.mark.parametrize("flags", [
    ["--mode", "open", "--target-qps", "400", "--arrival", "bursty"],
    ["--mode", "open", "--target-qps", "400", "--arrival", "diurnal",
     "--ramp-period-s", "0.1", "--priority", "mutation_first"],
    ["--mode", "closed", "--concurrency", "3", "--batch-timeout-ms", "2"],
    ["--mode", "open", "--elastic", "--target-qps", "400",
     "--max-replicas", "2", "--autoscale-interval-ms", "20"],
    ["--mode", "closed", "--elastic", "--concurrency", "4", "--slo-ms", "50"],
    ["--mode", "sync", "--stage-pipeline"],
], ids=["open-bursty", "open-diurnal", "closed", "open-elastic",
        "closed-elastic", "stage-pipeline"])
def test_serve_modes_run_on_cpu(flags, tmp_path):
    out = tmp_path / "run.json"
    doc = serve.main(["--config", SPEC, "--device", "cpu", "--docs", "24",
                      "--requests", "30", "--json-out", str(out), *flags])
    assert json.loads(out.read_text())["mode"] == doc["mode"]
    assert doc["device"] == "cpu" and doc["db"]["live"] > 0
    if doc["mode"] == "sync":
        assert doc["stage_pipeline"]["quality"]["context_recall"] > 0.5
        rows = doc["stage_pipeline"]["report"]
        assert [r["stage"] for r in rows] == STAGES
        assert all(r["n_items"] == rows[0]["n_items"] > 0 for r in rows)
        return
    s = doc["summary"]
    assert s["n_failed"] == 0 and sum(doc["ops"].values()) == 30
    assert s["n_queries"] == doc["ops"]["query"] > 0
    assert s["p50_latency_ms"] <= s["p95_latency_ms"] <= s["p99_latency_ms"]
    assert 0.0 <= s["slo_attainment"] <= 1.0
    assert doc["quality"]["context_recall"] > 0.5
    if doc["elastic"]:
        assert [r["stage"] for r in doc["stage_report"]] == STAGES
        assert all(r["replicas"] <= 2 for r in doc["stage_report"]) or \
            "--max-replicas" not in flags


def test_serve_scenario_list_and_sim(capsys):
    assert serve.main(["--scenario", "list"])["scenarios"] == \
        jscenario_names()
    assert "shard_scale -" in capsys.readouterr().out
    doc = serve.main(["--scenario", "steady", "--scenario-sim",
                      "--scenario-scale", "0.25", "--seed", "2",
                      "--device", "cpu"])
    assert doc["mode"] == "sim" and doc["seed"] == 2
    assert doc["summary"]["n_failed"] == 0
    assert doc["quality"]["context_recall"] > 0.5


@pytest.mark.parametrize("flags", [
    ["--mode", "sync", "--stage-pipeline"],
    ["--mode", "open", "--target-qps", "400"],
    ["--mode", "closed", "--concurrency", "3"],
], ids=["sync", "open-elastic", "closed-elastic"])
def test_serve_sharded_spec_runs_every_mode(flags, tmp_path):
    """``specs/sharded_ivf.json`` (4 shards; its autoscale block makes the
    open and closed runs elastic): every request answered, the shard
    count on the retrieval stage's row, the DB's spans in the trace."""
    trace = tmp_path / "trace.json"
    doc = serve.main(["--config", SHARDED_SPEC, "--device", "cpu", "--docs",
                      "24", "--requests", "30", "--trace-out", str(trace),
                      *flags])
    assert doc["db"]["n_shards"] == 4 and doc["db"]["live"] > 0
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"db.search", "db.shard_scan", "db.merge"} <= names
    if doc["mode"] == "sync":
        assert doc["stage_pipeline"]["quality"]["context_recall"] > 0.5
        return
    assert doc["elastic"]
    assert doc["summary"]["n_failed"] == 0 and sum(doc["ops"].values()) == 30
    assert doc["quality"]["context_recall"] > 0.5


def test_elastic_rows_and_gauges_carry_the_shards():
    """The elastic executor's snapshot rows give the retrieval stage the
    DB's shard count, and its gauges take the sharded DB's."""
    from repro_torch.core.registry import build

    pipe = build(PipelineSpec.from_file(SHARDED_SPEC), device="cpu")
    ex = ElasticExecutor(pipe)
    rows = {r["stage"]: r for r in ex.snapshot()}
    assert rows["retrieval"]["shards"] == 4.0
    assert all("shards" not in r for st, r in rows.items()
               if st != "retrieval")
    gauges = ex.gauges()
    assert gauges["db_shards"]() == 4.0
    assert gauges["db_shard_imbalance"]() == 1.0   # empty: balanced
    assert gauges["db_mesh_searches"]() == 0.0


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    ["--mode", "open", "--target-qps", "200"],
    ["--mode", "open", "--elastic", "--target-qps", "200",
     "--max-replicas", "2"]], ids=["open", "elastic"])
def test_serving_on_the_card(flags, tmp_path):
    """Open-loop and elastic serving of fused_ivf.json on the card: every
    request answered, and the retrieval kernels launched in the run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops.reset_launch_counts()
    doc = serve.main(["--config", SPEC, "--docs", "128", "--requests", "64",
                      "--update-frac", "0.2", "--trace-out",
                      str(tmp_path / "trace.json"), *flags])
    launches = ops.launch_counts()
    assert doc["device"] == "cuda"
    assert doc["summary"]["n_failed"] == 0
    assert sum(doc["ops"].values()) == 64
    assert launches["ivf_topk"] > 0 and launches["topk_search"] > 0, launches
