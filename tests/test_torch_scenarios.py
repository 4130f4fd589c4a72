"""The port's scenario suite against a live run of the JAX package's, on the
CPU (never against ``tests/golden/``: the reference's goldens drift on this
tree, and the port never reads them).

Both packages build each scenario's pipeline from the same seed. The hash
table and, after indexing, the DB state go across with
``repro_torch.convert``; the mutation-heavy scenarios rebuild the IVF index
mid-run, so every rebuild of the port also starts its k-means from the
reference's initial draw (``jax.random.choice``, which torch cannot
reproduce). Then per scenario:

* ``simulate()``: the timing fields, events and timelines equal, quality
  within 1e-9, and the Chrome trace recorded under a ``VirtualClock``
  identical;
* ``replay_outputs``: lock-step, staged and elastic give the reference's
  lock-step outputs request by request.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import VirtualClock as JVirtualClock  # noqa: E402
from repro.obs import chrome_trace_doc as jchrome_trace_doc  # noqa: E402
from repro.scenarios import ScenarioRunner as JRunner  # noqa: E402
from repro.scenarios import ScenarioSpec as JScenarioSpec  # noqa: E402
from repro.scenarios import golden_variant as jgolden_variant  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import vectordb as tvdb  # noqa: E402
from repro_torch.core.registry import build  # noqa: E402
from repro_torch.obs import (Tracer, VirtualClock, chrome_trace_doc,  # noqa: E402
                             validate_chrome_trace)
from repro_torch.scenarios import (ScenarioRunner, golden_variant,  # noqa: E402
                                   scenario_names)
from repro_torch.scenarios import runner as trunner  # noqa: E402
from repro_torch.serving.elastic import ReplicaKilled  # noqa: E402
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus  # noqa: E402

SCENARIOS = [n for n in scenario_names() if n != "shard_scale"]
QUALITY_TOL = 1e-9
# report blocks that must be equal, not merely close
EXACT = ("n_requests", "scaling_events", "knob_timeline", "fault_events",
         "stage_report", "trace_decomposition", "deterministic_replay")


@pytest.fixture
def reference_state(monkeypatch):
    """Build every port scenario pipeline from the reference's draws; lists
    the k-means runs of the port's index rebuilds since the state went
    across."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "xla")
    builds = []
    kmeans = tvdb.kmeans

    def kmeans_from_reference_init(x, k, iters=10, seed=0, init=None):
        if init is None:
            n = x.shape[0]
            idx = np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                             (k,), replace=n < k))
            init = x[torch.from_numpy(idx).long()]
        builds.append(k)
        return kmeans(x, k, iters, seed, init=init)

    def build_from_reference(self):
        jpipe, _ = JRunner(JScenarioSpec.from_dict(
            self.spec.to_dict()))._build()
        corpus = SyntheticCorpus(CorpusConfig(n_docs=self.spec.n_docs,
                                              seed=self.spec.seed))
        pipe = build(self.spec.pipeline_spec(), device=self.device,
                     embedder=convert.embedder_from_jax(jpipe.embedder))
        pipe.index_documents(corpus.all_documents(), build=False)
        pipe.db.load_state(convert.db_state(jpipe.db))
        builds.clear()
        return pipe, corpus

    monkeypatch.setattr(tvdb, "kmeans", kmeans_from_reference_init)
    monkeypatch.setattr(trunner.ScenarioRunner, "_build",
                        build_from_reference)
    return builds


@pytest.mark.parametrize("name", SCENARIOS)
def test_simulate_matches_reference(name, reference_state):
    jtracer, ttracer = JTracer(clock=JVirtualClock()), Tracer(
        clock=VirtualClock())
    want = JRunner(jgolden_variant(name)).simulate(tracer=jtracer).to_dict()
    got = ScenarioRunner(golden_variant(name), device="cpu").simulate(
        tracer=ttracer).to_dict()
    for key in EXACT:
        assert got[key] == want[key], key
    assert set(got["summary"]) == set(want["summary"])
    for key, val in want["summary"].items():
        assert abs(got["summary"][key] - val) <= QUALITY_TOL, key
    assert set(got["quality"]) == set(want["quality"])
    for key, val in want["quality"].items():
        assert abs(got["quality"][key] - val) <= QUALITY_TOL, key
    # the virtual-time trace: the same spans and instants, bit for bit
    doc = chrome_trace_doc(ttracer)
    assert json.dumps(doc) == json.dumps(jchrome_trace_doc(jtracer))
    assert validate_chrome_trace(doc) == [] and len(ttracer) > 100
    if name in ("update_storm", "mixed_interference"):
        # the IVF index was rebuilt mid-run from the injected draw
        assert reference_state


def _outputs(traces):
    return [(t.query, t.retrieved_ids, t.reranked_ids, t.answer,
             t.gold_chunk_ids) for t in traces]


@pytest.mark.parametrize("name", SCENARIOS)
def test_replay_outputs_match_reference_under_every_executor(
        name, reference_state):
    want = _outputs(JRunner(jgolden_variant(name)).replay_outputs(
        "lockstep"))
    assert want
    runner = ScenarioRunner(golden_variant(name), device="cpu")
    for executor in ("lockstep", "staged", "elastic"):
        got = runner.replay_outputs(executor)
        assert _outputs(got) == want, executor
        assert all(t.n_attempts == 1 for t in got)


def test_live_replica_failure_fails_only_by_the_injected_kill():
    """``serve()`` on the CPU with two replica kills: every request reaches
    a terminal state, and a request fails only with the injected kill."""
    spec = golden_variant("replica_failure").scaled(0.5)
    runner = ScenarioRunner(spec, device="cpu")
    errors = []
    orig = trunner.ServingHarness._finish

    def finish(self, sub, ok, err=None):
        if not ok:
            errors.append(err)
        return orig(self, sub, ok, err)

    trunner.ServingHarness._finish = finish
    try:
        report = runner.serve()
    finally:
        trunner.ServingHarness._finish = orig
    s = report.summary
    assert s["n_requests"] + s["n_failed"] == spec.n_requests
    assert all(isinstance(e, ReplicaKilled) for e in errors)
    assert len(errors) == s["n_failed"]
    injected = [e for e in report.fault_events if e["action"] == "inject"]
    assert [e["stage"] for e in injected] == ["retrieval", "generation"]
    assert report.quality["context_recall"] > 0.5
    assert {"p50_latency_ms", "p99_latency_ms", "slo_attainment",
            "goodput_qps"} <= set(s)
