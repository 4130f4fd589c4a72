"""The port's whole query slice against the JAX package's, on the CPU.

Both packages build the same spec (``src/repro_torch/specs/fused_ivf.json``,
whose JAX twin is the ``fused`` backend), index the same synthetic corpus
and replay the same seeded workload through ``run_workload``. The hash
table and, after indexing, the vector DB's state (centroids and buckets:
the two packages' random draws differ) are carried across with
``repro_torch.convert``. Per request the retrieved and reranked ids and the
answer must be equal, and the quality metrics agree within 1e-9.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes; the suite runs several workers at once, so one intra-op
# thread each keeps torch from crowding the timing-sensitive tests
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.core import embedder as jemb_mod  # noqa: E402
from repro.core import reranker as jrr_mod  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro.core.registry import build as jax_build  # noqa: E402
from repro.core.spec import PipelineSpec as JaxSpec  # noqa: E402
from repro.workload.corpus import CorpusConfig as JCorpusConfig  # noqa: E402
from repro.workload.corpus import SyntheticCorpus as JCorpus  # noqa: E402
from repro.workload.generator import WorkloadConfig as JWConfig  # noqa: E402
from repro.workload.runner import run_workload as jax_run  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.registry import build  # noqa: E402
from repro_torch.core.spec import PipelineSpec  # noqa: E402
from repro_torch.core.vectordb import DBConfig, TorchVectorDB  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.sharded import ShardedVectorDB  # noqa: E402
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus  # noqa: E402
from repro_torch.workload.generator import WorkloadConfig  # noqa: E402
from repro_torch.workload.runner import run_workload  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPECS = os.path.join(ROOT, "src", "repro_torch", "specs")
SPEC = os.path.join(SPECS, "fused_ivf.json")
# the quantized DB's specs: flat + sq8 (sq8_topk / quant_score), IVF + PQ
QUANT_SPECS = ["fused_flat_sq8", "op_flat_sq8", "fused_ivf_pq"]


def _jax_twin(spec_dict):
    d = json.loads(json.dumps(spec_dict))
    d["vectordb"]["component"] = {
        "torch_fused": "fused", "torch": "jax",
        "torch_sharded": "sharded"}[d["vectordb"]["component"]]
    return JaxSpec.from_dict(d)


def test_slice_matches_jax_request_by_request(monkeypatch):
    _assert_slice_matches_jax(SPEC, monkeypatch)


@pytest.mark.parametrize("name", QUANT_SPECS)
def test_quant_slice_matches_jax_request_by_request(name, monkeypatch):
    """The same replay on the quantized DB; its codes, scale and PQ
    codebook go across with the rest of the reference's DB state."""
    _assert_slice_matches_jax(os.path.join(SPECS, f"{name}.json"),
                              monkeypatch)


def _assert_slice_matches_jax(spec_path, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "xla")
    spec = PipelineSpec.from_file(spec_path)
    jpipe = jax_build(_jax_twin(spec.to_dict()))
    tpipe = build(spec, embedder=convert.embedder_from_jax(jpipe.embedder),
                  device="cpu")
    n_docs, seed = 48, 3
    jcorpus, tcorpus = (JCorpus(JCorpusConfig(n_docs=n_docs)),
                        SyntheticCorpus(CorpusConfig(n_docs=n_docs)))
    assert jpipe.index_documents(jcorpus.all_documents()) == \
        tpipe.index_documents(tcorpus.all_documents())
    # same chunks, bit-identical embeddings; then the reference's index
    n = jpipe.db.n_slots
    assert np.array_equal(tpipe.db.vectors[:n].numpy(), jpipe.db.vectors[:n])
    tpipe.db.load_state(convert.db_state(jpipe.db))
    kw = dict(query_frac=0.8, update_frac=0.2, n_requests=60, seed=seed)
    jres = jax_run(jpipe, jcorpus, JWConfig(**kw), query_batch=4)
    tres = run_workload(tpipe, tcorpus, WorkloadConfig(**kw), query_batch=4)
    assert len(tpipe.traces) == len(jpipe.traces) > 30
    assert tpipe.db.stats()["fresh"] > 0        # the freshness scan ran
    for jt, tt in zip(jpipe.traces, tpipe.traces):
        assert tt.query == jt.query
        assert tt.retrieved_ids == jt.retrieved_ids
        assert tt.reranked_ids == jt.reranked_ids
        assert tt.answer == jt.answer
        assert tt.gold_chunk_ids == jt.gold_chunk_ids
    assert set(tres.quality) == set(jres.quality)
    for key, val in jres.quality.items():
        assert abs(tres.quality[key] - val) <= 1e-9, key
    assert tpipe.db.counters["fused_searches"] == \
        jpipe.db.counters["fused_searches"]


def test_model_slice_matches_jax_request_by_request(monkeypatch):
    """``model_smoke.json``: the transformer embedder, the fused IVF DB, the
    cross-encoder and ``ModelLLM`` on the llama3 smoke config. The encoders'
    and the generator's weights go across from the reference, then its DB
    state. Run in fp32 copies of the configs, so that both packages agree
    to about 1e-6 and no near tie in retrieval, reranking or the greedy
    tokens can split them; bf16 is held to its tolerance at the module level
    (tests/test_torch_models.py). Per request the retrieved and reranked ids
    and the generated tokens must be equal."""
    _assert_model_slice_matches_jax(
        PipelineSpec.from_file(os.path.join(SPECS, "model_smoke.json")),
        monkeypatch)


def test_moe_sharded_slice_matches_jax_request_by_request(monkeypatch):
    """``model_qwen3_moe_30b_a3b.json`` at the smoke config of its
    generator: the transformer embedder, the 4-shard fused IVF DB (every
    shard's state carried across), the cross-encoder and ``ModelLLM`` on
    Qwen3-MoE, as ``test_model_slice_matches_jax_request_by_request``
    holds the dense slice."""
    spec = PipelineSpec.from_file(
        os.path.join(SPECS, "model_qwen3_moe_30b_a3b.json"))
    spec.llm.options["smoke"] = True
    _assert_model_slice_matches_jax(spec, monkeypatch)


def _assert_model_slice_matches_jax(spec, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "xla")
    for mod in (jemb_mod, jrr_mod):
        orig = mod.encoder_config
        monkeypatch.setattr(
            mod, "encoder_config",
            lambda _orig=orig, **kw: _orig(**kw).replace(dtype="float32"))
    opts = spec.llm.options
    jllm = JModelLLM(
        jconfigs.get_smoke(opts["arch"]).replace(dtype="float32"),
        max_prompt=opts["max_prompt"], max_new=opts["max_new"],
        batch_size=opts["batch_size"])
    jpipe = jax_build(_jax_twin(spec.to_dict()), llm=jllm)
    tpipe = build(
        spec, embedder=convert.transformer_embedder_from_jax(jpipe.embedder,
                                                             "cpu"),
        reranker=convert.cross_reranker_from_jax(jpipe.reranker, "cpu"),
        llm=convert.model_llm_from_jax(jllm, "cpu"), device="cpu")
    n_docs, seed = 24, 5
    jcorpus, tcorpus = (JCorpus(JCorpusConfig(n_docs=n_docs)),
                        SyntheticCorpus(CorpusConfig(n_docs=n_docs)))
    assert jpipe.index_documents(jcorpus.all_documents()) == \
        tpipe.index_documents(tcorpus.all_documents())
    for jdb, tdb in zip(getattr(jpipe.db, "shards", [jpipe.db]),
                        getattr(tpipe.db, "shards", [tpipe.db])):
        n = jdb.n_slots
        np.testing.assert_allclose(tdb.vectors[:n].numpy(), jdb.vectors[:n],
                                   rtol=1e-5, atol=1e-5)
    if isinstance(tpipe.db, ShardedVectorDB):
        tpipe.db.load_state(convert.sharded_db_state(jpipe.db))
    else:
        tpipe.db.load_state(convert.db_state(jpipe.db))
    kw = dict(query_frac=0.9, update_frac=0.1, n_requests=24, seed=seed)
    jax_run(jpipe, jcorpus, JWConfig(**kw), query_batch=4)
    run_workload(tpipe, tcorpus, WorkloadConfig(**kw), query_batch=4)
    assert len(tpipe.traces) == len(jpipe.traces) > 15
    for jt, tt in zip(jpipe.traces, tpipe.traces):
        assert tt.query == jt.query
        assert tt.retrieved_ids == jt.retrieved_ids
        assert tt.reranked_ids == jt.reranked_ids
        assert tt.answer == jt.answer and len(tt.answer.split()) == 16
    assert tpipe.llm.stats.n_requests == jllm.stats.n_requests
    assert tpipe.llm.stats.tokens_out == jllm.stats.tokens_out


def test_serve_main_runs_a_smoke_arch_on_cpu():
    """``--arch --smoke --max-new`` put a ModelLLM in the llm slot of the
    ``--config`` spec, and the run document carries its gen block."""
    doc = serve.main(["--config", SPEC, "--arch", "llama3_8b", "--smoke",
                      "--max-new", "3", "--docs", "16", "--requests", "8",
                      "--device", "cpu"])
    assert doc["gen"]["n_requests"] > 0
    assert doc["gen"]["tokens_out"] == 3 * doc["gen"]["n_requests"]
    assert doc["stage_breakdown"]["generation"] > 0


@pytest.mark.parametrize("name", QUANT_SPECS)
def test_serve_main_runs_quant_specs_on_cpu(name):
    """Each quantized spec serves through its rung, and the DB stats of the
    run document carry the quantized index bytes."""
    spec = os.path.join(SPECS, f"{name}.json")
    doc = serve.main(["--config", spec, "--docs", "24", "--requests", "16",
                      "--device", "cpu"])
    db = PipelineSpec.from_file(spec).vectordb
    assert doc["quality"] and doc["db"]["searches"] > 0
    # code bytes per row: dim (384, the DB default) for sq8, pq_m for PQ
    per_row = 384 if db.options["quant"] == "sq8" else db.options["pq_m"]
    assert doc["db"]["index_bytes"] >= doc["db"]["slots"] * per_row > 0
    assert (doc["db"]["fused_searches"] > 0) == (db.component == "torch_fused")


def test_serve_main_runs_on_cpu(tmp_path):
    out = tmp_path / "run.json"
    doc = serve.main(["--config", SPEC, "--mode", "sync", "--docs", "24",
                      "--requests", "16", "--device", "cpu",
                      "--json-out", str(out)])
    assert doc["quality"] and json.loads(out.read_text())["device"] == "cpu"
    assert doc["db"]["fused_searches"] > 0


@pytest.mark.parametrize("key,value", [
    ("gen", {"enabled": True}), ("autoscale", {"enabled": True}),
    ("replicas", 4)])
def test_spec_rejects_unported_serving_features(key, value):
    """A JAX-format spec's serving features load and write back as the
    reference writes them: the token-level engine's ``gen`` block, the
    elastic executor's ``replicas`` and ``autoscale`` keys. Every one is
    ported now, so none is rejected."""
    full = JaxSpec.from_dict(PipelineSpec.from_file(SPEC).to_dict()).to_dict()
    assert PipelineSpec.from_dict(full).to_dict() == \
        PipelineSpec.from_file(SPEC).to_dict()
    if key == "replicas":
        full["vectordb"]["replicas"] = value
    else:
        full[key] = {**full[key], **value}
    got = PipelineSpec.from_dict(full).to_dict()
    assert got == full
    if key == "gen":
        assert PipelineSpec.from_dict(full).gen.enabled
    if key == "replicas":
        assert PipelineSpec.from_dict(full).stage_replicas()["retrieval"] == 4


def test_port_imports_nothing_of_jax():
    """Import every module of the port in a fresh interpreter, the
    experiments and the examples too: neither jax nor any module of the JAX
    package may load."""
    code = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
for path in sorted((root / "repro_torch").rglob("*.py")):
    mod = ".".join(path.relative_to(root).with_suffix("").parts)
    importlib.import_module(mod.removesuffix(".__init__"))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
# the experiments and the examples among them
for sub in ("experiments", "examples"):
    mods = sorted((root / "repro_torch" / sub).glob("*.py"))
    assert len(mods) > 4, sub
    for path in mods:
        assert f"repro_torch.{sub}.{path.stem}".removesuffix(".__init__") \
            in sys.modules, path
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code, src], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    # chip_smoke.py imports only the port (some of it inside functions)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    top = {name.split(".")[0] for name in names}
    assert "repro_torch" in top and not top & {"jax", "jaxlib", "repro"}


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_port_passes_lock_and_clock_lint():
    """The port's own linter (``repro_torch.analysis``) finds nothing in
    ``src/repro_torch`` with all four passes: the reference's
    ``# guarded-by:`` / ``# locked-by:`` discipline and deterministic
    zones, the port's registry, specs, scenario catalog and experiment
    table (conformance) and its gauge schema."""
    from repro_torch.analysis.core import PASS_NAMES, run_passes
    findings, _ = run_passes(os.path.abspath(ROOT), passes=PASS_NAMES)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_db_without_device_needs_cuda(monkeypatch):
    """The port runs on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchVectorDB(DBConfig(dim=16, capacity=8))
