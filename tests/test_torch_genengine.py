"""The port's token-level generation engine against the JAX package's, on
the CPU.

The reference's parameters go across (``repro_torch.convert``) in fp32
copies of the llama3 smoke config (its own dtype is bf16): the chunk
attention and the chunked prefill must match within 1e-5 and 1e-4, and the
port's engine, built from the reference engine by ``engine_from_jax``, must
give the reference engine's greedy tokens (``parity.compare_tokens``: equal
except from a step whose reference top-2 logit gap lies within 1e-4) with
the same scheduling counts in every setting of ``tests/test_genengine.py``.
The port's own engine holds to its lock-step ``ModelLLM``; the service API,
clones, the ``max_new`` knob, the ``gen`` spec block and every serve mode
with ``--gen-engine`` run here too. The ``cuda`` case runs the engine on
the card against the CPU.
"""
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro.core.spec import GenSpec as JGenSpec  # noqa: E402
from repro.core.spec import PipelineSpec as JPipelineSpec  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.genengine import \
    engine_from_model_llm as jengine_from_model_llm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.generator import (GenStats, ModelLLM,  # noqa: E402
                                        build_prompt, render_tokens)
from repro_torch.core.registry import build  # noqa: E402
from repro_torch.core.spec import GenSpec, PipelineSpec, StageSpec  # noqa: E402
from repro_torch.core.stages import GenerateStage  # noqa: E402
from repro_torch.kernels.parity import compare_tokens  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.obs import Tracer, WallClock  # noqa: E402
from repro_torch.serving.arrival import ArrivalConfig, arrival_times  # noqa: E402
from repro_torch.serving.genengine import (EngineCounters,  # noqa: E402
                                           EngineLLM, GenEngine,
                                           engine_from_model_llm)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPECS = os.path.join(ROOT, "src", "repro_torch", "specs")
JCFG = jconfigs.get_smoke("llama3_8b").replace(dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))
TOKEN_TOL = 1e-4     # greedy picks: the reference's top-2 logit gap
OUT_TOL = 1e-5       # cached_attention_chunk's output, fp32
LOGIT_TOL = 1e-4     # prefill_chunk's logits, fp32

PROMPTS = [
    "what is the capital of entity seven",
    "short",
    "a much longer question containing many distinct content words about "
    "systems benchmarks retrieval generation latency throughput quality "
    "alpha beta gamma delta epsilon zeta",
    "tell me about alpha beta gamma delta",
    "x",
    "medium length question about entity twelve and entity nine",
]
# (slots, chunk_tokens, prefill_chunks_per_step, admission) as the
# reference's equivalence test runs them
SETTINGS = [(2, 8, 1, "fcfs"), (3, 16, 2, "fcfs"), (1, 8, 1, "fcfs"),
            (2, 8, 2, "sjf")]
NO_CONTEXT = [[] for _ in PROMPTS]


@pytest.fixture(scope="module")
def jllm():
    return JModelLLM(JCFG, max_prompt=48, max_new=5, batch_size=2, seed=0)


@pytest.fixture(scope="module")
def jref(jllm):
    return jllm.generate(PROMPTS, NO_CONTEXT)


@pytest.fixture(scope="module")
def tllm():
    """The port's own lock-step generator (its own seeded weights)."""
    return ModelLLM(CFG, max_prompt=48, max_new=5, batch_size=2, seed=0,
                    device="cpu")


def _ids(answers):
    return np.array([[int(w[3:]) for w in a.split()] for a in answers])


def _jax_gaps(jllm, ids):
    """The reference's top-1 minus top-2 logit at each greedy step of each
    prompt, from a full forward over the prompt and its tokens."""
    gaps = []
    for text, row in zip(PROMPTS, ids):
        prompt = jllm.tok.encode(build_prompt(text, []), jllm.max_prompt)
        seq = np.array(prompt + list(row[:-1]), np.int32)[None]
        logits, _ = JT.forward(jllm.params, jllm.cfg,
                               {"tokens": jnp.asarray(seq)})
        top = np.sort(np.asarray(logits[0, len(prompt) - 1:], np.float32),
                      axis=1)[:, -2:]
        gaps.append(top[:, 1] - top[:, 0])
    return np.stack(gaps)


def _port_gaps(llm, ids):
    """The same gaps from the port's model, for its own lock-step run."""
    gaps = []
    with torch.no_grad():
        for text, row in zip(PROMPTS, ids):
            prompt = llm.tok.encode(build_prompt(text, []), llm.max_prompt)
            seq = torch.tensor([prompt + list(row[:-1])])
            top = llm.model(seq)[0, len(prompt) - 1:].topk(2).values
            gaps.append((top[:, 0] - top[:, 1]).float().numpy())
    return np.stack(gaps)


def _layer0_attn(params):
    return {k: np.asarray(v, np.float32)[0]
            for k, v in params["layers"]["attn"].items()}


# -- the model pieces ----------------------------------------------------------


@pytest.mark.parametrize("offset,C,stale", [(0, 8, False), (8, 8, True),
                                            (5, 3, True), (16, 4, True)])
def test_cached_attention_chunk_matches_jax(jllm, offset, C, stale):
    """C tokens at [offset, offset + C) against a cache whose positions at
    and past offset hold stale K/V (a previous occupant's): the same output
    within OUT_TOL and the same cache, the chunk written in place."""
    rng = np.random.default_rng(100 * offset + C)
    B, M, hd = 2, 24, CFG.resolved_head_dim
    attn = _layer0_attn(jllm.params)
    x = rng.standard_normal((B, C, CFG.d_model)).astype(np.float32)
    shape = (B, M, CFG.n_kv_heads, hd)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    if not stale:
        ck[:, offset:], cv[:, offset:] = 0.0, 0.0
    jout, jck, jcv = JL.cached_attention_chunk(
        {k: jnp.asarray(v) for k, v in attn.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), offset, JCFG)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tout = TL.cached_attention_chunk(
        {k: torch.from_numpy(v) for k, v in attn.items()},
        torch.from_numpy(x), tck, tcv, offset, CFG)
    assert tout.shape == (B, C, CFG.d_model)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), rtol=0,
                               atol=OUT_TOL)
    # the untouched positions kept their contents
    assert np.array_equal(tck.numpy()[:, :offset], ck[:, :offset])
    assert np.array_equal(tck.numpy()[:, offset + C:], ck[:, offset + C:])


@pytest.mark.parametrize("C", [8, 5])
def test_prefill_chunk_matches_jax(jllm, C):
    """Two chunks of one prompt, the second against the first's cache:
    every position's logits within LOGIT_TOL of the reference's, and the
    second chunk's equal to a full forward's over the whole prompt."""
    model = convert.transformer_from_jax(jllm.params, CFG, device="cpu")
    rng = np.random.default_rng(C)
    tokens = rng.integers(4, CFG.vocab_size, (2, 2 * C)).astype(np.int32)
    jcache = JT.init_cache(JCFG, 2, 4 * C)
    tcache = model.init_cache(2, 4 * C)
    full = None
    for off in (0, C):
        chunk = tokens[:, off:off + C]
        jlog, jcache = JT.prefill_chunk(jllm.params, JCFG,
                                        {"tokens": jnp.asarray(chunk)},
                                        jcache, off)
        with torch.no_grad():
            tlog, tcache = model.prefill_chunk(torch.from_numpy(chunk),
                                               tcache, off)
            if full is None:
                full = model(torch.from_numpy(tokens))
        assert tlog.shape == (2, C, CFG.vocab_size)
        assert tcache["pos"] == 0          # left to the caller
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(tlog.numpy(),
                                   full[:, off:off + C].numpy(), rtol=0,
                                   atol=LOGIT_TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=LOGIT_TOL)


# -- the engine against the reference's ---------------------------------------


@pytest.mark.parametrize("slots,chunk,budget,admission", SETTINGS)
def test_engine_from_jax_gives_the_jax_engines_tokens(jllm, jref, slots,
                                                      chunk, budget,
                                                      admission):
    jeng = jengine_from_model_llm(jllm, slots=slots, chunk_tokens=chunk,
                                  prefill_chunks_per_step=budget,
                                  admission=admission)
    teng = convert.engine_from_jax(jeng, device="cpu")
    assert (teng.slots, teng.chunk_tokens, teng.prefill_chunks_per_step,
            teng.admission, teng.max_len) == (
        slots, chunk, budget, admission, jeng.max_len)
    texts = [build_prompt(p, []) for p in PROMPTS]   # generate()'s
    want = jeng.run(texts)
    got = teng.run(texts)
    assert want == jref          # the reference's own equivalence
    ref = _ids(want)
    assert ref.shape == (len(PROMPTS), 5)
    cmp = compare_tokens(ref, _ids(got), _jax_gaps(jllm, ref), TOKEN_TOL)
    assert cmp["violations"] == 0, (cmp, want, got)
    assert (teng.stats.n_requests, teng.stats.tokens_out) == (
        jeng.stats.n_requests, jeng.stats.tokens_out) == (6, 30)
    assert (teng.n_steps, teng.n_prefill_chunks, teng.n_decode_steps) == (
        jeng.n_steps, jeng.n_prefill_chunks, jeng.n_decode_steps)


def test_softcapped_engine_gives_the_jax_engines_tokens():
    """A config with ``attn_logit_softcap = 50`` (Gemma 2's,
    arXiv:2408.00118): the engine carried across by
    ``convert.engine_from_jax`` prefills in chunks (``cached_attention_chunk``
    with the capped scores) and decodes to the JAX engine's tokens, by the
    near-tie rule."""
    jllm = JModelLLM(JCFG.replace(attn_logit_softcap=50.0), max_prompt=48,
                     max_new=5, batch_size=2, seed=0)
    jeng = jengine_from_model_llm(jllm, slots=2, chunk_tokens=8,
                                  prefill_chunks_per_step=1, admission="fcfs")
    teng = convert.engine_from_jax(jeng, device="cpu")
    assert teng.cfg.attn_logit_softcap == 50.0
    texts = [build_prompt(p, []) for p in PROMPTS]
    want = _ids(jeng.run(texts))
    got = _ids(teng.run(texts))
    cmp = compare_tokens(want, got, _jax_gaps(jllm, want), TOKEN_TOL)
    assert cmp["violations"] == 0, (cmp, want, got)
    assert teng.n_prefill_chunks == jeng.n_prefill_chunks > len(PROMPTS)


@pytest.mark.parametrize("slots,chunk,budget,admission", SETTINGS)
def test_engine_gives_the_lockstep_tokens(tllm, slots, chunk, budget,
                                          admission):
    """The port's own engine on its lock-step generator's weights."""
    want = tllm.generate(PROMPTS, NO_CONTEXT)
    eng = engine_from_model_llm(tllm, slots=slots, chunk_tokens=chunk,
                                prefill_chunks_per_step=budget,
                                admission=admission)
    assert eng.core.model is tllm.model
    got = EngineLLM(engine=eng).generate(PROMPTS, NO_CONTEXT)
    ref = _ids(want)
    cmp = compare_tokens(ref, _ids(got), _port_gaps(tllm, ref), TOKEN_TOL)
    assert cmp["violations"] == 0, (cmp, want, got)
    counts = eng.counters.summary()
    assert counts["decode_steps"] == eng.n_decode_steps > 0
    assert 1.0 <= counts["mean_active_slots"] <= slots


# -- the service API -----------------------------------------------------------


def test_engine_service_api_under_open_loop_arrivals(tllm):
    """``submit``/``step`` driven by a seeded open-loop schedule gives the
    batch path's tokens and anchors each TTFT at the arrival."""
    want = EngineLLM(engine=engine_from_model_llm(
        tllm, slots=2, chunk_tokens=8)).generate(PROMPTS, NO_CONTEXT)
    eng = engine_from_model_llm(tllm, slots=2, chunk_tokens=8)
    texts = [build_prompt(p, []) for p in PROMPTS]
    offsets = arrival_times(ArrivalConfig(
        mode="open", process="poisson", target_qps=400.0,
        n_requests=len(PROMPTS), seed=5))
    t0 = time.perf_counter()
    rids, submitted = [], 0
    while submitted < len(PROMPTS) or eng.busy():
        now = time.perf_counter()
        while submitted < len(PROMPTS) and t0 + offsets[submitted] <= now:
            rids.append(eng.submit(texts[submitted],
                                   t_arrive=t0 + offsets[submitted]))
            submitted += 1
        if not eng.step() and submitted < len(PROMPTS):
            time.sleep(max(0.0, t0 + offsets[submitted]
                           - time.perf_counter()))
    recs = [eng.records.pop(r) for r in rids]
    assert [render_tokens(r.out) for r in recs] == want
    wall = time.perf_counter() - t0
    for r, off in zip(recs, offsets):
        assert r.ttft_s == pytest.approx(r.t_first - (t0 + off))
        assert 0.0 < r.ttft_s <= wall
    assert eng.stats.n_requests == len(PROMPTS)


def test_engine_admission_sjf_prefers_short_prompts(tllm):
    eng = engine_from_model_llm(tllm, slots=1, chunk_tokens=8, max_new=2,
                                admission="sjf")
    long_rid = eng.submit(PROMPTS[2], t_arrive=0.0)
    short_rid = eng.submit("x", t_arrive=0.0)
    while eng.busy():
        eng.step()
    assert eng.records[short_rid].t_first < eng.records[long_rid].t_first


def test_engine_llm_clone_shares_weights_stats_and_counters(tllm):
    llm = EngineLLM(engine=engine_from_model_llm(tllm, slots=2,
                                                 chunk_tokens=8, max_new=2))
    twin = llm.clone()
    assert twin.engine is not llm.engine
    assert twin.engine.core is llm.engine.core
    assert twin.engine.cache["k"].data_ptr() != llm.engine.cache["k"].data_ptr()
    assert twin.stats is llm.stats
    assert twin.engine.counters is llm.engine.counters
    assert llm.generate(PROMPTS[:2], [[], []]) == \
        twin.generate(PROMPTS[:2], [[], []])
    assert llm.stats.n_requests == 4


def test_generate_stage_replica_copy_clones_engine(tllm):
    llm = EngineLLM(engine=engine_from_model_llm(tllm, slots=2,
                                                 chunk_tokens=8))
    stage = GenerateStage(llm, batch_size=3)
    twin = stage.replica_copy()
    assert twin is not stage and twin.llm.engine is not stage.llm.engine
    assert twin.llm.stats is stage.llm.stats
    assert twin.batch_size == stage.batch_size


def test_engine_set_max_new_clamped_and_applied(tllm):
    eng = engine_from_model_llm(tllm, slots=1, chunk_tokens=8, max_new=6)
    assert eng.set_max_new(3) == 3
    rid = eng.submit("a question about entities", t_arrive=0.0)
    while eng.busy():
        eng.step()
    assert len(eng.records[rid].out) == 3
    assert eng.set_max_new(99) == 6       # clamped to the cache's ceiling
    # a clone made under the degraded knob keeps the full ceiling
    eng.set_max_new(2)
    twin = eng.clone()
    assert twin.max_new == 2 and twin.set_max_new(8) == 6
    assert twin.max_len == eng.max_len


def test_run_releases_per_request_records(tllm):
    eng = engine_from_model_llm(tllm, slots=2, chunk_tokens=8, max_new=2)
    eng.run(PROMPTS[:4])
    assert eng.records == {}


def test_engine_records_gen_instants(tllm):
    """A tracer on the engine gets the reference's three token-level
    instants: one ``gen.prefill_chunk`` per prefill call, one
    ``gen.first_token`` and one ``gen.retire`` per request."""
    eng = engine_from_model_llm(tllm, slots=2, chunk_tokens=8, max_new=3)
    eng.tracer = Tracer(clock=WallClock())
    eng.run(PROMPTS)
    names = [i.name for i in eng.tracer.instants()]
    assert names.count("gen.first_token") == names.count("gen.retire") == 6
    assert 6 <= names.count("gen.prefill_chunk") <= eng.n_prefill_chunks
    assert eng.clone().tracer is eng.tracer


def test_stats_and_counters_reset_and_count_under_threads():
    stats, counters = GenStats(), EngineCounters()

    def pound():
        for i in range(500):
            stats.record(0.001 * i, 0.0001, 2)
            counters.add(steps=1, decode_steps=1, decode_rows=3)

    threads = [threading.Thread(target=pound) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert stats.n_requests == 2000 and stats.tokens_out == 4000
    assert counters.summary()["mean_active_slots"] == 3.0
    before, kept = stats.copy(), counters.copy()
    stats.record(1.0, 1.0, 9)
    counters.add(steps=7)
    stats.reset(before)
    counters.reset(kept)
    assert stats.n_requests == 2000 and len(stats.ttft_s) == 2000
    assert counters.steps == 2000
    stats.reset()
    counters.reset()
    assert stats.n_requests == 0 and counters.summary()["steps"] == 0


# -- the spec block, the pipeline and serve ------------------------------------


@pytest.mark.parametrize("gen", [
    {"enabled": True, "slots": 6, "chunk_tokens": 16,
     "prefill_chunks_per_step": 2, "admission": "sjf"},
    {}])
def test_gen_spec_round_trips_as_the_reference_writes_it(gen):
    jspec = JPipelineSpec.from_dict(
        {"llm": {"component": "model", "options": {"arch": "llama3_8b"}},
         "gen": gen})
    full = jspec.to_dict()
    spec = PipelineSpec.from_dict(full)
    assert spec.gen.to_dict() == JGenSpec.from_dict(gen).to_dict()
    assert spec.to_dict()["gen"] == full["gen"]
    assert PipelineSpec.from_json(spec.to_json()) == spec
    with pytest.raises(ValueError):
        PipelineSpec.from_dict({**full, "gen": {**full["gen"], "bogus": 1}})
    assert PipelineSpec().to_dict()["gen"] == JPipelineSpec().to_dict()["gen"]


def test_gen_block_builds_engine_backed_pipeline():
    spec = PipelineSpec(
        llm=StageSpec("model", {"arch": "llama3_8b", "smoke": True,
                                "max_prompt": 48, "max_new": 3,
                                "batch_size": 4}),
        gen=GenSpec(enabled=True, slots=2, chunk_tokens=8))
    pipe = build(spec, device="cpu")
    assert isinstance(pipe.llm, EngineLLM)
    assert pipe.llm.engine.slots == 2 and pipe.llm.engine.max_new == 3
    assert pipe.llm.engine.device == torch.device("cpu")
    pipe2 = build(dataclasses.replace(spec, gen=GenSpec(enabled=False)),
                  device="cpu")
    assert isinstance(pipe2.llm, ModelLLM)
    engine_spec = PipelineSpec.from_file(
        os.path.join(SPECS, "model_llama3_8b_engine.json"))
    assert engine_spec.gen == GenSpec(enabled=True, slots=8, chunk_tokens=128,
                                      prefill_chunks_per_step=4)
    lockstep = PipelineSpec.from_file(os.path.join(SPECS,
                                                   "model_llama3_8b.json"))
    assert dataclasses.replace(engine_spec, gen=GenSpec()) == lockstep


@pytest.mark.parametrize("flags", [
    ["--mode", "sync"],
    ["--mode", "open", "--target-qps", "400"],
    ["--mode", "closed", "--concurrency", "3"],
    ["--mode", "open", "--elastic", "--target-qps", "400",
     "--max-replicas", "2", "--autoscale-interval-ms", "20"]],
    ids=["sync", "open", "closed", "elastic"])
def test_serve_gen_engine_runs_every_mode(flags, tmp_path):
    out = tmp_path / "run.json"
    doc = serve.main(["--config", os.path.join(SPECS, "model_smoke.json"),
                      "--device", "cpu", "--gen-engine", "--gen-slots", "3",
                      "--gen-chunk", "64", "--gen-admission", "sjf",
                      "--docs", "16", "--requests", "10", "--trace-out",
                      str(tmp_path / "trace.json"), "--json-out", str(out),
                      *flags])
    assert json.loads(out.read_text())["engine"] == doc["engine"]
    n_queries = doc["ops"]["query"]
    gen, eng = doc["gen"], doc["engine"]
    assert gen["n_requests"] == n_queries > 0
    if doc.get("elastic"):   # the quality ladder may shorten answers
        assert n_queries <= gen["tokens_out"] <= 16 * n_queries
    else:
        assert gen["tokens_out"] == 16 * n_queries
    assert eng["prefill_chunks"] >= n_queries and eng["decode_steps"] > 0
    assert 1.0 <= eng["mean_active_slots"] <= 3.0 * (
        2 if doc.get("elastic") else 1)
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"gen.prefill_chunk", "gen.first_token", "gen.retire"} <= names
    if doc["mode"] != "sync":
        assert doc["summary"]["n_failed"] == 0


def test_serve_gen_engine_needs_the_model_llm(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--config", os.path.join(SPECS, "fused_ivf.json"),
                    "--device", "cpu", "--gen-engine"])
    assert "--gen-engine needs the 'model' llm" in capsys.readouterr().err


@pytest.mark.parametrize("engine", [False, True], ids=["lockstep", "engine"])
def test_closed_loop_counts_no_warm_up_request(engine):
    """``warm_up``'s query is not a request of the run: the gen block
    counts the queries served, with the lock-step generator or the
    engine."""
    doc = serve.main(["--config", os.path.join(SPECS, "model_smoke.json"),
                      "--device", "cpu", "--mode", "closed", "--docs", "16",
                      "--requests", "8", "--concurrency", "2"]
                     + (["--gen-engine"] if engine else []))
    assert doc["gen"]["n_requests"] == doc["summary"]["n_queries"] == \
        doc["ops"]["query"] > 0
    if engine:
        assert doc["engine"]["prefill_chunks"] >= doc["ops"]["query"]


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_on_the_card_matches_the_cpu(cuda_device, dtype):
    """One set of seeded weights on the CPU and on the card: the card's
    engine gives the CPU lock-step's tokens by the near-tie rule (bf16:
    the logits' tolerance of ``test_torch_models``)."""
    cfg = configs.get_smoke("llama3_8b").replace(dtype=dtype)
    cpu = ModelLLM(cfg, max_prompt=48, max_new=5, batch_size=2, seed=0,
                   device="cpu")
    card = ModelLLM(cfg, max_prompt=48, max_new=5, batch_size=2, seed=0,
                    device=cuda_device,
                    model=convert_model(cpu.model, cfg, cuda_device))
    want = cpu.generate(PROMPTS, NO_CONTEXT)
    got = EngineLLM(engine=engine_from_model_llm(
        card, slots=3, chunk_tokens=16, prefill_chunks_per_step=2)
    ).generate(PROMPTS, NO_CONTEXT)
    ref = _ids(want)
    tol = TOKEN_TOL if dtype == "float32" else 0.125
    cmp = compare_tokens(ref, _ids(got), _port_gaps(cpu, ref), tol)
    assert cmp["violations"] == 0, (cmp, want, got)


def convert_model(model, cfg, device):
    """A copy of ``model``'s weights on ``device``."""
    from repro_torch.models.transformer import Transformer
    twin = Transformer(cfg, device=device)
    twin.load_state_dict(model.state_dict())
    return twin
