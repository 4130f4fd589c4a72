"""The port's figure experiments (``repro_torch.experiments``: Figs. 5-8
and §5.8 here, Figs. 9-12 in ``test_torch_experiments_workloads.py``, which
takes this file's stand-ins) against the JAX package's ``benchmarks/``, on
the CPU.

Each experiment runs in both packages at scale ``SCALE``, where every size
sits on the reference's floor. The two packages draw different random
numbers, so the port's pipelines take the reference's: its hash tables
(``convert.embedder_from_jax``), its transformer embedder
(``convert.transformer_embedder_from_jax``) and its generation models
(``convert.model_llm_from_jax``), through a stand-in for each experiment's
``build_pipeline``; and every k-means run of the port's DB starts from the
reference's initial draw (``jax.random.choice``), injected into
``repro_torch.core.vectordb.kmeans``. Then, row by row:

``repro_torch.experiments.common.compare_rows`` holds the rows, the rule
``chip_smoke.py`` holds the card's rows to against the CPU's:

* the same ``bench`` names and keys in the same order (the monitor's device
  gauge is ``torch_device_bytes`` in the port, ``jax_device_bytes`` in the
  reference; a monitor gauge's row exists only where one of its 20 ms
  samples landed, so it may be missing on one side);
* counts and bytes equal;
* quality fields equal, flat and IVF configs alike (with the reference's
  draws carried across, every one reads equal);
* timing fields present, finite and not negative; a rate or a total
  positive.
"""
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)   # the reference's benchmarks/ (no __init__.py)

from benchmarks import common as bcommon  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro.core.registry import create as jcreate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import vectordb as tvdb  # noqa: E402
from repro_torch.core.generator import ModelLLM  # noqa: E402
from repro_torch.core.pipeline import RAGPipeline  # noqa: E402
from repro_torch.core.registry import build  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.experiments import run as trun  # noqa: E402

SCALE = 0.01
FIGURES = ["query_breakdown", "indexing_breakdown", "resource_utilization",
           "accuracy_eval", "update_workload", "resource_limits",
           "sensitivity", "index_schemes", "monitor_overhead"]
# this file's share: the Fig. 5-8 and §5.8 experiments
HERE = ["query_breakdown", "indexing_breakdown", "resource_utilization",
        "accuracy_eval", "monitor_overhead"]
# the monitor's device-memory gauge, by package
GAUGE_NAMES = {"resource_utilization/jax_device_bytes":
               "resource_utilization/torch_device_bytes"}

_tables = {}


def reference_embedder(stage):
    """The port's embedder for a spec's embedder slot, holding the
    reference's table or weights."""
    dim = stage.options["dim"]
    if stage.component == "hash":
        if dim not in _tables:
            _tables[dim] = convert.embedder_from_jax(
                jcreate("embedder", "hash", dim=dim))
        return _tables[dim]
    return convert.transformer_embedder_from_jax(
        jcreate("embedder", stage.component, dim=dim), device="cpu")


def reference_llm(llm: ModelLLM) -> ModelLLM:
    """The port's ModelLLM with the reference's weights for the same smoke
    config and sizes."""
    arch = next(a for a in jconfigs.ARCH_IDS
                if jconfigs.get_smoke(a).name == llm.cfg.name)
    return convert.model_llm_from_jax(
        JModelLLM(jconfigs.get_smoke(arch), max_prompt=llm.max_prompt,
                  max_new=llm.max_new, batch_size=llm.batch_size),
        device="cpu")


def build_from_reference(corpus=None, llm=None, index=True, device="cuda",
                         **overrides) -> RAGPipeline:
    """``common.build_pipeline`` with the reference's draws."""
    spec = tcommon.default_spec(**overrides)
    if isinstance(llm, ModelLLM):
        llm = reference_llm(llm)
    pipe = build(spec, llm=llm, device=device,
                 embedder=reference_embedder(spec.embedder))
    if corpus is not None and index:
        pipe.index_documents(corpus.all_documents())
    return pipe


@pytest.fixture
def reference_draws(monkeypatch):
    """Every port pipeline of the experiments built from the reference's
    draws; lists the k-means runs of the port's DBs."""
    runs = []
    kmeans = tvdb.kmeans

    def kmeans_from_reference_init(x, k, iters=10, seed=0, init=None):
        if init is None:
            n = x.shape[0]
            idx = np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                             (k,), replace=n < k))
            init = x[torch.from_numpy(idx).long()]
        runs.append(k)
        return kmeans(x, k, iters, seed, init=init)

    monkeypatch.setattr(tvdb, "kmeans", kmeans_from_reference_init)
    monkeypatch.setattr(tcommon, "build_pipeline", build_from_reference)
    for name in FIGURES:
        monkeypatch.setattr(trun.MODULES[name], "build_pipeline",
                            build_from_reference)
    return runs


def compare_rows(want, got):
    """The reference's rows against the port's (``common.compare_rows``,
    quality equal), the device gauge under the port's name."""
    want = [dict(r, bench=GAUGE_NAMES.get(r["bench"], r["bench"]))
            for r in want]
    tcommon.compare_rows(want, got)


def run_both(name, kmeans_runs):
    """Run experiment ``name`` in both packages and hold the rows."""
    ref = importlib.import_module(f"benchmarks.{name}")
    want = ref.run(SCALE)
    got = trun.MODULES[name].run(SCALE, device="cpu")
    compare_rows(want, got)
    if name not in ("monitor_overhead", "resource_utilization"):
        assert kmeans_runs   # an IVF index was built from the draw


@pytest.mark.parametrize("name", HERE)
def test_experiment_matches_reference(name, reference_draws):
    run_both(name, reference_draws)


LEGACY_CASES = [
    {},
    {"index_type": "flat", "quant": "sq8"},
    {"use_hybrid": False, "flat_capacity": 64, "rebuild_threshold": 0.9},
    {"embedder": "transformer", "embed_dim": 64, "reranker": "bi"},
    {"capacity": 1 << 14, "nlist": 64, "retrieve_k": 16, "rerank_k": 4,
     "flat_capacity": 4096, "use_kernel": "fused"},
    {"llm": "model", "llm_arch": "llama3_8b", "gen_batch": 4,
     "max_new_tokens": 4},
]


@pytest.mark.parametrize("knobs", LEGACY_CASES)
def test_default_spec_is_the_references_legacy_mapping(knobs):
    """``default_spec`` maps the legacy knobs as the reference's
    ``PipelineSpec.from_config`` does, with the port's vector DB."""
    want = bcommon.default_spec(**knobs).to_dict()
    want["vectordb"]["component"] = "torch"
    assert tcommon.default_spec(**knobs).to_dict() == want


def test_default_spec_rejects_an_unknown_knob():
    with pytest.raises(TypeError):
        bcommon.default_spec(nprobes=3)
    with pytest.raises(TypeError, match="nprobes"):
        tcommon.default_spec(nprobes=3)


@pytest.mark.parametrize("name", sorted(trun.MODULES))
def test_experiment_runs_on_the_card_unless_asked(name, monkeypatch):
    """``run``'s default device is the card: without one it raises before
    building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.MODULES[name].run(SCALE)


def test_run_prints_csv_and_names_failures(monkeypatch, capsys):
    assert trun.main(["--only", "monitor_overhead", "--scale", str(SCALE),
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "benchmark,metric,value"
    assert {line.split(",")[1] for line in out[1:-1]} == {
        "baseline_s", "monitored_s", "overhead_frac", "probe_cost_s"}
    assert out[-1].startswith("monitor_overhead,wall_s,")

    def boom(scale, device):
        raise ValueError("planted")

    monkeypatch.setattr(trun.MODULES["monitor_overhead"], "run", boom)
    assert trun.main(["--only", "monitor_overhead", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out.splitlines()[-1] == "FAILED: monitor_overhead"
    assert "planted" in captured.err


class _CudaDB:
    """A DB that says it lies on the card and records when it is used."""

    device = torch.device("cuda", 0)

    def __init__(self, log):
        self.log = log

    def insert(self, vecs, chunks):
        self.log.append("insert")

    def build_index(self):
        self.log.append("build")

    def update(self, doc_id, vecs, chunks):
        self.log.append("update")


def test_indexing_stages_wait_for_the_card(monkeypatch):
    """The ``insertion`` and ``index_build`` stages end by synchronising a
    DB on the card, so their host-clock time includes its queued work."""
    log = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: log.append(("sync", str(dev))))
    pipe = build(tcommon.default_spec(), db=_CudaDB(log), device="cpu")
    pipe.index_documents([(0, "the capital of entity0 is val1.")])
    pipe.update_document(0, "the capital of entity0 is val2.", version=1)
    assert log == ["insert", ("sync", "cuda:0"), "build", ("sync", "cuda:0"),
                   "update", ("sync", "cuda:0")]
    assert {"insertion", "index_build"} <= set(pipe.breakdown())
