"""The port's retrieval experiments (``repro_torch.experiments``:
``fused_retrieve`` and ``sharded_retrieval``) against the JAX package's
``benchmarks/``, on the CPU.

Both packages run each experiment at ``SCALE`` (every size on the
reference's floor). Every k-means run of the port's DBs starts from the
reference's initial draw (``jax.random.choice``), injected into
``repro_torch.core.vectordb.kmeans``; the scenario pipelines of the
sharded sweep take the reference's hash table. Then, by
``repro_torch.experiments.common.compare_rows`` (the rule ``chip_smoke.py``
holds the card's rows to against the CPU's):

* ``fused_retrieve``: the same ``bench`` names and keys in order; the
  equivalence rows hold under the parity rule
  (``repro_torch.kernels.parity``: ids equal outside near ties, |d score|
  <= 1e-5) on every config; the roofline rows equal; the latency rows'
  sizes equal and their times positive. The gate's own DB, built the same way in both
  packages, gives the reference's top-k by the parity rule on both rungs,
  fresh and after mutations.
* ``sharded_retrieval``: names and keys in order; shard counts, the
  1-shard identity and the shard imbalance equal; recall within
  ``RECALL_TOL`` (the reference's own ``RECALL_EPSILON``: its k-means and
  the port's sum in other orders); the simulated sweep's latencies, SLO
  attainment and goodput within 1e-9 (virtual time); ``check`` passes.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)   # the reference's benchmarks/ (no __init__.py)

from benchmarks import fused_retrieve as bfused  # noqa: E402
from benchmarks import sharded_retrieval as bsharded  # noqa: E402
from repro.core.interfaces import Chunk as JChunk  # noqa: E402
from repro.core.registry import create as jcreate  # noqa: E402
from repro.core.vectordb import DBConfig as JDBConfig  # noqa: E402
from repro.core.vectordb import JaxVectorDB  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import vectordb as tvdb  # noqa: E402
from repro_torch.core.interfaces import Chunk  # noqa: E402
from repro_torch.core.registry import build  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.experiments import fused_retrieve as tfused  # noqa: E402
from repro_torch.experiments import sharded_retrieval as tsharded  # noqa: E402
from repro_torch.kernels.parity import compare_topk  # noqa: E402
from repro_torch.scenarios import runner as trunner  # noqa: E402
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus  # noqa: E402

SCALE = 0.01
RECALL_TOL = bsharded.RECALL_EPSILON


@pytest.fixture
def reference_kmeans(monkeypatch):
    """Every port k-means run starts from the reference's draw; lists the
    runs."""
    runs = []
    kmeans = tvdb.kmeans

    def from_reference_init(x, k, iters=10, seed=0, init=None):
        if init is None:
            n = x.shape[0]
            idx = np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                             (k,), replace=n < k))
            init = x[torch.from_numpy(idx).long()]
        runs.append(k)
        return kmeans(x, k, iters, seed, init=init)

    monkeypatch.setattr(tvdb, "kmeans", from_reference_init)
    return runs


@pytest.fixture
def reference_table(monkeypatch, reference_kmeans):
    """The scenario runner's pipelines hold the reference's hash table."""
    tables = {}

    def build_with_reference_table(self):
        spec = self.spec
        pspec = spec.pipeline_spec()
        dim = pspec.embedder.options["dim"]
        if dim not in tables:
            tables[dim] = convert.embedder_from_jax(
                jcreate("embedder", "hash", dim=dim))
        corpus = SyntheticCorpus(CorpusConfig(n_docs=spec.n_docs,
                                              seed=spec.seed))
        pipe = build(pspec, device=self.device, embedder=tables[dim])
        pipe.index_documents(corpus.all_documents())
        return pipe, corpus

    monkeypatch.setattr(trunner.ScenarioRunner, "_build",
                        build_with_reference_table)
    return reference_kmeans


def test_fused_retrieve_matches_reference(reference_kmeans):
    want = bfused.run(SCALE)
    got = tfused.run(SCALE, device="cpu")
    tcommon.compare_rows(want, got)
    assert tfused.check(got, latency_gate=False) == []


@pytest.mark.parametrize("index_type,quant", bfused.CONFIGS)
def test_fused_gate_db_matches_reference_db(index_type, quant,
                                            reference_kmeans):
    """The gate's DB, built from the same rows in both packages: the
    port's ``off`` and ``fused`` rungs give the reference's top-k, fresh
    and after the gate's mutations."""
    n, dim, k = 256, 32, 8
    vecs, q = tfused._corpus(n, dim)
    jvecs, jq = bfused._corpus(n, dim)
    assert np.array_equal(vecs, jvecs) and np.array_equal(q, jq)
    fresh = np.random.default_rng(7).standard_normal((12, dim)).astype(
        np.float32)
    jdb = JaxVectorDB(JDBConfig(
        index_type=index_type, quant=quant, dim=dim, capacity=n + 64,
        nlist=8, nprobe=4, flat_capacity=64, pq_m=4, use_kernel=False))
    jdb.insert(vecs.copy(), [JChunk(chunk_id=-1, doc_id=i // 4, text=f"c{i}")
                             for i in range(n)])
    jdb.build_index()
    tdb = tfused.make_db(index_type, quant, vecs, "cpu")
    qt = torch.from_numpy(q)
    for phase in ("built", "mutated"):
        if phase == "mutated":
            for db, cls in ((jdb, JChunk), (tdb, Chunk)):
                db.remove(1)
                db.remove(17)
                db.insert(fresh.copy(), [cls(chunk_id=-1, doc_id=9000 + i,
                                             text=f"f{i}")
                                         for i in range(len(fresh))])
        sa, ia = jdb._search_arrays(jnp.asarray(q), k)
        for rung in ("off", "fused"):
            sb, ib = tdb.search_arrays(qt, k, rung=rung)
            rep = compare_topk(np.asarray(sa), np.asarray(ia), sb, ib)
            assert rep["violations"] == 0, (phase, rung, rep)
    if index_type == "ivf" or quant == "pq":
        assert reference_kmeans


def test_fused_retrieve_gates_latency_on_the_card_only():
    rows = [{"bench": "fused_retrieve/latency_sq8", "speedup": 0.5},
            {"bench": "fused_retrieve/latency_pq", "speedup": 2.0}]
    assert tfused.check(rows, latency_gate=False) == []
    errs = tfused.check(rows)
    assert len(errs) == 1 and errs[0].startswith(
        "fused_retrieve/latency_sq8: speedup 0.50x below")


def test_fused_retrieve_smoke_check_passes_on_the_cpu(capsys):
    assert tfused.main(["--smoke", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("CHECK OK") and "not gated on the CPU" in out[-1]
    assert "fused_retrieve/latency_pq,speedup," in "\n".join(out)


def test_sharded_retrieval_matches_reference(reference_table):
    want = bsharded.run(SCALE)
    got = tsharded.run(SCALE, device="cpu")
    tcommon.compare_rows(want, got, quality_tol=RECALL_TOL)
    assert got[0]["output_identical"] == 1.0
    assert tsharded.check(got) == []
    assert reference_table


def test_sharded_retrieval_smoke_check_passes_on_the_cpu(capsys):
    assert tsharded.main(["--smoke", "--check", "--scale", str(SCALE),
                          "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("CHECK OK")
