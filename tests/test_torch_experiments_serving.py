"""The port's live serving studies (``repro_torch.experiments``: serving,
stage_pipeline, elastic_scaling, overhead) against the JAX package's
``benchmarks/``, on the CPU, and the row rule that holds them
(``experiments.common.compare_rows``).

Each study runs in both packages at scale ``SCALE`` (every size on the
reference's floor), the port's pipelines built from the reference's draws
(its hash tables and k-means draws, the stand-ins of
``test_torch_experiments_figures.py`` and ``_retrieval.py``). Their rows
are measurements of the wall clock but for the flags, the configured sizes
and the samples a seeded stream fixes, so ``compare_rows`` holds: the same
bench names and keys in order; ``serving``'s offered load and concurrency,
the equivalence flag, the overhead gate's rounds, scale and sample counts
equal; every other value finite and not negative, a throughput positive.
The timing gates (elastic against static, the 3 % tracing budget) run on
the card (``chip_smoke.py``), not here; their logic is held here on planted
measurements.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_experiments_figures import (  # noqa: E402,F401
    build_from_reference, reference_draws, reference_embedder)
from test_torch_experiments_retrieval import (  # noqa: E402,F401
    reference_kmeans, reference_table)

from benchmarks import elastic_scaling as belastic  # noqa: E402
from benchmarks import overhead as boverhead  # noqa: E402
from benchmarks import run as brun  # noqa: E402
from benchmarks import serving as bserving  # noqa: E402
from benchmarks import stage_pipeline as bstage  # noqa: E402
from repro_torch.core.registry import build  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.experiments import elastic_scaling as telastic  # noqa: E402
from repro_torch.experiments import overhead as toverhead  # noqa: E402
from repro_torch.experiments import run as trun  # noqa: E402
from repro_torch.experiments import serving as tserving  # noqa: E402
from repro_torch.experiments import stage_pipeline as tstage  # noqa: E402
from repro_torch.serving import staged as tstaged  # noqa: E402

SCALE = 0.01
OVERHEAD_RUNS = 1     # interleaved rounds of the overhead rows (3 by default)


@pytest.fixture
def live_draws(monkeypatch, reference_draws):
    """The live studies' pipelines built from the reference's draws."""
    for mod in (tserving, tstage):
        monkeypatch.setattr(mod, "build_pipeline", build_from_reference)

    def fresh_pipeline(n_docs, seed, device="cuda"):
        corpus = tcommon.make_corpus(n_docs, seed=seed)
        spec = telastic.SCENARIO.pipeline_spec()
        pipe = build(spec, device=device,
                     embedder=reference_embedder(spec.embedder))
        pipe.index_documents(corpus.all_documents())
        return pipe, corpus

    monkeypatch.setattr(telastic, "_fresh_pipeline", fresh_pipeline)
    return reference_draws


@pytest.mark.parametrize("name", ["serving", "stage_pipeline",
                                  "elastic_scaling"])
def test_live_study_matches_reference(name, live_draws):
    ref = {"serving": bserving, "stage_pipeline": bstage,
           "elastic_scaling": belastic}[name]
    want = ref.run(SCALE)
    got = trun.MODULES[name].run(SCALE, device="cpu")
    assert tcommon.compare_rows(want, got) > 0 or name == "stage_pipeline"
    if name == "elastic_scaling":
        assert got[-1]["equivalent"] == 1.0
        assert live_draws    # an IVF index was built from the draw


def test_overhead_matches_reference(reference_table):
    want = boverhead.run(SCALE, runs=OVERHEAD_RUNS)
    got = toverhead.run(SCALE, device="cpu", runs=OVERHEAD_RUNS)
    # runs, scale and both sample counts
    assert tcommon.compare_rows(want, got) == 4
    assert got[0]["n_spans"] > 0 and got[0]["n_samples_on"] > 0


def test_modules_are_the_references_in_order():
    assert list(trun.MODULES) == list(brun.MODULES)


def test_stage_pipeline_asserts_identical_outputs(monkeypatch):
    """A pipelined run that answers differently from lock-step raises."""
    run = tstaged.StagedExecutor.run

    def changed(self, *args, **kw):
        res = run(self, *args, **kw)
        res.traces[0].answer += "!"
        return res

    monkeypatch.setattr(tstaged.StagedExecutor, "run", changed)
    with pytest.raises(AssertionError, match="changed outputs"):
        tstage._run_point(32, 96, 4, device="cpu")


def _elastic_doc(equivalent, replay, static, elastic):
    return {"equivalent_outputs": equivalent,
            "static": dict(zip(("goodput_qps", "p99_ms"), static)),
            "elastic": dict(zip(("goodput_qps", "p99_ms"), elastic),
                            deterministic_replay=replay)}


@pytest.mark.parametrize("doc", [
    _elastic_doc(True, True, (10.0, 100.0), (12.0, 90.0)),
    _elastic_doc(True, True, (10.0, 100.0), (9.0, 90.0)),
    _elastic_doc(True, True, (10.0, 100.0), (12.0, 110.0)),
    _elastic_doc(True, True, (10.0, 100.0), (9.0, 110.0)),
    _elastic_doc(False, False, (10.0, 100.0), (10.0, 100.0)),
])
def test_elastic_check_is_the_references(doc):
    """Elastic fails only when worse on both goodput and p99, or when its
    outputs or its replay diverge."""
    assert telastic.check(doc) == belastic.check(doc)


def _overhead(tput_ratio, p99_ratio):
    return {"tput_on_qps": 100.0 * tput_ratio, "tput_off_qps": 100.0,
            "p99_on_ms": 50.0 * p99_ratio, "p99_off_ms": 50.0,
            "tput_ratio": tput_ratio, "p99_ratio": p99_ratio}


@pytest.mark.parametrize("ratios", [(1.0, 1.0), (0.969, 1.0), (1.0, 1.031),
                                    (0.97, 1.03), (0.5, 2.0)])
def test_overhead_budget_is_the_references(ratios):
    m = _overhead(*ratios)
    assert toverhead.TOLERANCE == boverhead.TOLERANCE == 0.03
    assert toverhead.violations(m) == boverhead.violations(m)


@pytest.mark.parametrize("retry", [(1.0, 1.0), (1.0, 1.05)])
def test_overhead_gate_remeasures_once_at_doubled_rounds(monkeypatch,
                                                         retry):
    calls = []

    def measure(scale, runs, device):
        calls.append((scale, runs, device))
        return _overhead(*retry)

    monkeypatch.setattr(toverhead, "measure", measure)
    said = []
    m, bad = toverhead.gate(_overhead(1.0, 1.2), 0.5, 3, "cpu",
                            say=said.append)
    assert calls == [(0.5, 6, "cpu")] and len(said) == 2
    assert m == _overhead(*retry)
    assert bad == toverhead.violations(_overhead(*retry))
    calls.clear()
    assert toverhead.gate(_overhead(1.0, 1.0), 0.5, 3, "cpu") == (
        _overhead(1.0, 1.0), [])
    assert calls == []


# -- compare_rows is no looser for the rows it held before --------------------

def _fails(want, got, **kw):
    with pytest.raises(AssertionError):
        tcommon.compare_rows([want], [got], **kw)


SHARDED = {"bench": "sharded_retrieval/scale_1x_4shard", "corpus_scale": 1,
           "shards": 4, "p99_latency_ms": 12.5, "p95_latency_ms": 10.25,
           "slo_attainment": 0.96875, "goodput_qps": 31.0}


@pytest.mark.parametrize("key", ["p99_latency_ms", "p95_latency_ms",
                                 "slo_attainment", "goodput_qps"])
def test_sharded_sweep_virtual_time_held_within_sim_tol(key):
    assert tcommon.compare_rows([SHARDED], [dict(SHARDED)]) == 6
    _fails(SHARDED, dict(SHARDED, **{key: SHARDED[key] + 1e-6}))


@pytest.mark.parametrize("key,delta", [("context_recall", 1e-12),
                                       ("f1", 1e-6), ("exact", 0.25)])
def test_figure_quality_held_equal(key, delta):
    row = {"bench": "accuracy_eval/flat", "chunks": 10, key: 0.5}
    assert tcommon.compare_rows([row], [dict(row)]) == 2
    _fails(row, dict(row, **{key: 0.5 + delta}))


SCENARIO_ROW = {"bench": "scenarios/steady", "n_requests": 32,
                "p95_latency_ms": 40.5, "slo_attainment": 1.0,
                "goodput_qps": 24.0, "quality_goodput_qps": 20.0,
                "quality_weight": 0.8, "n_scaling_events": 2,
                "n_knob_moves": 1, "deterministic": 1.0}


@pytest.mark.parametrize("key,delta", [
    ("n_requests", 1), ("p95_latency_ms", 1e-6), ("slo_attainment", 1e-6),
    ("goodput_qps", 1e-6), ("quality_goodput_qps", 1e-12),
    ("quality_weight", 1e-12), ("n_scaling_events", 1),
    ("n_knob_moves", 1), ("deterministic", -1.0)])
def test_sim_rows_held_in_every_key(key, delta):
    assert tcommon.compare_rows([SCENARIO_ROW], [dict(SCENARIO_ROW)]) == 9
    _fails(SCENARIO_ROW, dict(SCENARIO_ROW,
                              **{key: SCENARIO_ROW[key] + delta}))


LIVE_ROWS = [
    {"bench": "serving_open_q25", "offered_qps": 25.0, "achieved_qps": 19.0,
     "p99_ms": 120.0, "slo_attainment": 0.9, "goodput_qps": 17.0},
    {"bench": "serving_closed_c4", "concurrency": 4.0, "achieved_qps": 80.0,
     "p99_ms": 60.0, "goodput_qps": 80.0},
    {"bench": "gen_engine/b8s12", "equivalent": 1, "offered_qps": 14.0,
     "lockstep_ttft_p95_ms": 261.0, "engine_ttft_p95_ms": 51.6,
     "ttft_p95_speedup": 5.06},
    {"bench": "elastic_scaling/gain", "goodput_gain": 1.1, "p99_gain": 1.2,
     "n_events": 3, "equivalent": 1.0},
    {"bench": "overhead/steady", "runs": 3.0, "scale": 0.5,
     "n_samples_off": 300.0, "n_samples_on": 300.0, "n_spans": 1500.0,
     "p99_on_ms": 30.0, "tput_on_qps": 40.0},
]


def test_live_rows_hold_configuration_and_measure_the_rest():
    """A live row whose measurements differ (its p99 among them) passes;
    one whose configured value or flag differs fails."""
    got = [{k: (v * 1.7 if k not in tcommon.LIVE_EXACT_KEYS | {"bench"}
                and not (r["bench"].startswith("serving_")
                         and k in tcommon.SERVING_SET_KEYS) else v)
            for k, v in r.items()} for r in LIVE_ROWS]
    assert got[0]["p99_ms"] != LIVE_ROWS[0]["p99_ms"]
    assert tcommon.compare_rows(LIVE_ROWS, got) == 8
    for i, key in [(0, "offered_qps"), (1, "concurrency"),
                   (2, "equivalent"), (3, "equivalent"), (4, "runs"),
                   (4, "scale"), (4, "n_samples_on")]:
        _fails(LIVE_ROWS[i], dict(got[i], **{key: got[i][key] + 1}))
    _fails(LIVE_ROWS[0], dict(got[0], p99_ms=-1.0))
    _fails(LIVE_ROWS[0], dict(got[0], achieved_qps=0.0))
    _fails(LIVE_ROWS[4], dict(got[4], p99_on_ms=float("nan")))
