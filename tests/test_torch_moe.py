"""The port's MoE family against the JAX package's, on the CPU.

The reference's parameters (``repro.models.moe.moe_params_init``,
``repro.models.transformer.init``) go across as numpy arrays or through
``repro_torch.convert``; the same seeded inputs go through both. The
``SMOKE`` configs' ``capacity_factor`` of 8 drops no token; every test also
runs at 1.0 and 0.5, where tokens are dropped (``expert_capacity`` slots an
expert and group). Tolerances, fp32:

* ``moe_apply`` outputs and aux loss: 1e-5 (the expert products sum in
  another order);
* model logits and caches: 1e-4, as ``tests/test_torch_models.py``;
* greedy tokens: ``repro_torch.kernels.parity.compare_tokens``, equal
  except from a step where the reference's top-2 logit gap is within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro.core.generator import build_prompt as jbuild_prompt  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.genengine import \
    engine_from_model_llm as jengine_from_model_llm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.interfaces import Chunk  # noqa: E402
from repro_torch.kernels.parity import compare_tokens  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

MOE = ["qwen3_moe_30b_a3b", "granite_moe_1b_a400m"]
# None keeps the SMOKE config's 8.0 (nothing dropped)
CAPACITY = [None, 1.0, 0.5]
OUT_TOL = 1e-5
LOGIT_TOL = 1e-4


def _cfgs(arch, capacity_factor, dtype="float32"):
    jcfg = jconfigs.get_smoke(arch).replace(dtype=dtype)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    return jcfg, convert.model_config(jcfg)


def _moe_inputs(jcfg, g, s, seed=0):
    params = jmoe.moe_params_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(
        (g, s, jcfg.d_model)).astype(np.float32)
    return params, x


def _t(params):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in params.items()}


def _dropped(cfg, params, x):
    """Routed slots of ``x [G,S,D]`` past their expert's capacity."""
    m = cfg.moe
    _, idx, _ = moe._router(_t(params), torch.from_numpy(x), m)
    cap = moe.expert_capacity(x.shape[1], m)
    counts = torch.stack([torch.bincount(r.reshape(-1), minlength=m.num_experts)
                          for r in idx])
    return int((counts - cap).clamp(min=0).sum())


@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", sorted(moe.MOE_IMPLS))
def test_moe_apply_matches_jax(impl, arch, capacity_factor):
    """Each dispatch against the reference's, on [3, 24, D] tokens (3
    groups); with drops at capacity 1.0 and below."""
    jcfg, cfg = _cfgs(arch, capacity_factor)
    params, x = _moe_inputs(jcfg, 3, 24)
    jy, jaux = jmoe.moe_apply(params, jnp.asarray(x), jcfg, impl)
    y, aux = moe.moe_apply(_t(params), torch.from_numpy(x), cfg, impl)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=OUT_TOL)
    assert abs(float(aux) - float(jaux)) <= OUT_TOL
    dropped = _dropped(cfg, params, x)
    assert (dropped == 0) == (capacity_factor is None), dropped
    _, none = moe.moe_apply(_t(params), torch.from_numpy(x), cfg, impl,
                            with_aux=False)
    assert none is None


@pytest.mark.parametrize("arch", MOE)
def test_router_takes_lax_top_k_order_on_ties(arch):
    """Equal gates (a zero router) pick the lowest experts, in order, and
    weigh them equally, as ``lax.top_k`` does."""
    jcfg, cfg = _cfgs(arch, None)
    params, x = _moe_inputs(jcfg, 1, 4)
    params = dict(params, router=jnp.zeros_like(params["router"]))
    jv, ji, _ = jmoe._router(params, jnp.asarray(x), jcfg.moe)
    v, i, _ = moe._router(_t(params), torch.from_numpy(x), cfg.moe)
    k = cfg.moe.top_k
    assert i.tolist() == np.asarray(ji).tolist() == [[list(range(k))] * 4]
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=0)


def _tokens(rng, lengths, S, vocab):
    tok = np.zeros((len(lengths), S), np.int32)
    for r, n in enumerate(lengths):
        tok[r, :n] = rng.integers(4, vocab, n)
    return tok


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _model_pair(arch, capacity_factor):
    jcfg, cfg = _cfgs(arch, capacity_factor)
    params = JT.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jcfg, params, convert.transformer_from_jax(np_params, cfg, "cpu")


@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_moe_transformer_matches_jax(arch, capacity_factor):
    """forward, prefill with per-row lengths (a batch row a routing group;
    pad tokens take capacity) and three decode steps (the batch one
    group), then two chunks of ``prefill_chunk`` against the cache."""
    jcfg, params, model = _model_pair(arch, capacity_factor)
    assert model.layers[0].moe["router"].dtype == torch.float32
    lengths = np.array([24, 17, 9], np.int32)
    tok = _tokens(np.random.default_rng(1), lengths, 24, jcfg.vocab_size)
    jlog, _ = JT.forward(params, jcfg, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        _close(model(torch.from_numpy(tok)), jlog)
        jcache = JT.init_cache(jcfg, 3, 32)
        jl, jcache = JT.prefill(params, jcfg, {"tokens": jnp.asarray(tok)},
                                jcache, lengths=jnp.asarray(lengths))
        cache = model.init_cache(3, 32)
        tl, cache = model.prefill(torch.from_numpy(tok), cache,
                                  lengths=torch.from_numpy(lengths))
        _close(tl, jl)
        _close(cache["k"], jcache["k"])
        for _ in range(3):   # the reference's greedy tokens go to both
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jl, jcache = JT.decode_step(params, jcfg,
                                        {"tokens": jnp.asarray(nxt)}, jcache)
            tl, cache = model.decode_step(torch.from_numpy(nxt), cache)
            _close(tl, jl)
        _close(cache["v"], jcache["v"])
        assert cache["pos"].tolist() == (lengths + 3).tolist()

        C = 8
        jc, tc = JT.init_cache(jcfg, 3, 4 * C), model.init_cache(3, 4 * C)
        for off in (0, C):
            chunk = tok[:, off:off + C]
            jlog, jc = JT.prefill_chunk(params, jcfg,
                                        {"tokens": jnp.asarray(chunk)}, jc,
                                        off)
            tlog, tc = model.prefill_chunk(torch.from_numpy(chunk), tc, off)
            _close(tlog, jlog)
        _close(tc["k"], jc["k"])


@pytest.mark.parametrize("arch", MOE)
def test_decode_routes_the_batch_as_one_group(arch, monkeypatch):
    """The decode step hands ``moe_apply`` one ``[1, B, D]`` group, a
    prefill and a chunk one group per batch row."""
    _, _, model = _model_pair(arch, None)
    shapes = []
    real = moe.moe_apply

    def spy(params, x, cfg, impl="sort", with_aux=True):
        shapes.append(tuple(x.shape[:2]))
        return real(params, x, cfg, impl, with_aux)

    monkeypatch.setattr(moe, "moe_apply", spy)
    tok = torch.randint(4, 512, (3, 6))
    n = model.cfg.n_layers
    with torch.no_grad():
        cache = model.init_cache(3, 12)
        logits, cache = model.prefill(tok, cache)
        model.decode_step(logits.argmax(-1)[:, None], cache)
        model.prefill_chunk(tok[:, :4], model.init_cache(3, 12), 0)
    assert shapes == [(3, 6)] * n + [(1, 3)] * n + [(3, 4)] * n


def _ids(answers):
    return np.array([[int(w[3:]) for w in a.split()] for a in answers])


PROMPTS = ["what is the capital of entity seven", "short",
           "a much longer question about systems benchmarks retrieval "
           "generation latency throughput quality alpha beta gamma",
           "tell me about alpha beta gamma delta", "x"]


def _jax_gaps(jllm, texts, ids):
    gaps = []
    for text, row in zip(texts, ids):
        prompt = jllm.tok.encode(text, jllm.max_prompt)
        seq = np.array(prompt + list(row[:-1]), np.int32)[None]
        logits, _ = JT.forward(jllm.params, jllm.cfg,
                               {"tokens": jnp.asarray(seq)})
        top = np.sort(np.asarray(logits[0, len(prompt) - 1:], np.float32),
                      axis=1)[:, -2:]
        gaps.append(top[:, 1] - top[:, 0])
    return np.stack(gaps)


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
@pytest.mark.parametrize("arch", MOE)
def test_model_llm_and_engine_give_the_jax_tokens(arch, capacity_factor):
    """``ModelLLM`` (batches of 2, the second padded) and ``GenEngine``
    (2 slots, chunks of 8: inactive slots take decode capacity) carried
    across by ``convert``: the reference's greedy tokens."""
    jcfg, _ = _cfgs(arch, capacity_factor)
    jllm = JModelLLM(jcfg, max_prompt=40, max_new=4, batch_size=2, seed=0)
    texts = [jbuild_prompt(p, []) for p in PROMPTS]
    want = jllm.generate(PROMPTS, [[] for _ in PROMPTS])
    ref = _ids(want)
    gaps = _jax_gaps(jllm, texts, ref)
    tllm = convert.model_llm_from_jax(jllm, device="cpu")
    got = tllm.generate(PROMPTS, [[] for _ in PROMPTS])
    cmp = compare_tokens(ref, _ids(got), gaps, LOGIT_TOL)
    assert cmp["violations"] == 0, (cmp, want, got)
    jeng = jengine_from_model_llm(jllm, slots=2, chunk_tokens=8,
                                  prefill_chunks_per_step=1)
    teng = convert.engine_from_jax(jeng, device="cpu")
    jtok, ttok = _ids(jeng.run(texts)), _ids(teng.run(texts))
    cmp = compare_tokens(jtok, ttok, _jax_gaps(jllm, texts, jtok), LOGIT_TOL)
    assert cmp["violations"] == 0, (cmp, jtok, ttok)
    assert teng.n_decode_steps == jeng.n_decode_steps > 0


def test_moe_configs_are_the_reference_data():
    for arch in MOE:
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(jconfigs.get_config(arch))
        assert dataclasses.asdict(tconfigs.get_smoke(arch)) == \
            dataclasses.asdict(jconfigs.get_smoke(arch))


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_bf16_on_the_card_matches_fp32_on_the_cpu(
        arch, capacity_factor):
    """The sort dispatch in bf16 on the card against fp32 on the CPU, from
    the same bf16-rounded weights and tokens (the router then sees equal
    fp32 inputs): |d| <= 2e-2 (1 + |want|), bf16's rounding of the
    products, the gates and the scatter-add."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jcfg, cfg = _cfgs(arch, capacity_factor)
    params, x = _moe_inputs(jcfg, 4, 64, seed=3)
    bf = {k: v.to(torch.bfloat16) if k != "router" else v
          for k, v in _t(params).items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want, _ = moe.moe_apply({k: v.float() for k, v in bf.items()},
                            xb.float(), cfg)
    card = cfg.replace(dtype="bfloat16")
    got, _ = moe.moe_apply({k: v.cuda() for k, v in bf.items()}, xb.cuda(),
                           card, with_aux=False)
    assert got.dtype == torch.bfloat16
    d = (got.float().cpu() - want).abs()
    assert bool((d <= 2e-2 * (1 + want.abs())).all()), float(d.max())


@pytest.mark.parametrize("arch", MOE)
def test_engine_equals_lockstep_only_without_drops(arch):
    """The engine routes each prompt chunk as a group where lock-step
    routes a whole padded row, so under capacity drops (factor 1.0) the
    two drop other tokens and their outputs part; with a capacity no group
    can fill (num_experts / top_k) they compute one function and give the
    same greedy tokens (fp32)."""
    from repro_torch.core.generator import ModelLLM
    from repro_torch.serving.genengine import EngineLLM, engine_from_model_llm

    texts = [" ".join(f"w{(i * 131 + j) % 997}" for j in range(20 + 9 * i))
             for i in range(8)]
    questions = [f"what is item-{i}" for i in range(8)]
    contexts = [[Chunk(i, i, t)] for i, t in enumerate(texts)]
    differ = {}
    base = _cfgs(arch, None)[1]
    m = base.moe
    for cf in (1.0, m.num_experts / m.top_k):
        cfg = base.replace(moe=dataclasses.replace(m, capacity_factor=cf))
        llm = ModelLLM(cfg, max_prompt=128, max_new=6, batch_size=8,
                       device="cpu")
        want = _ids(llm.generate(questions, contexts))
        eng = engine_from_model_llm(llm, slots=8, chunk_tokens=16,
                                    prefill_chunks_per_step=4)
        got = _ids(EngineLLM(engine=eng).generate(questions, contexts))
        differ[cf] = int((got != want).any(1).sum())
    assert differ[m.num_experts / m.top_k] == 0 and differ[1.0] > 0, differ
