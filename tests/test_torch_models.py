"""The port's dense model path against the JAX package's, on the CPU.

The JAX package's parameters (``repro.models.transformer.init``) go across
with ``repro_torch.convert``; the same seeded numpy token ids go through
both. Tolerances:

* fp32 copies of the smoke configs: 1e-4 (the attention, norms and matrix
  products sum in other orders; the measured gap is about 4e-6 on logits of
  magnitude 2-4);
* bf16 (the configs' own dtype): 0.125 on logits and cache entries, eight
  bf16 ulps at their magnitude of 2-4. Both packages round every tensor to
  bf16, but at different places (XLA's CPU backend keeps fused elementwise
  chains such as the norm and the activation in fp32), so the results differ
  by a few ulps; the measured gap is about 0.04.
* greedy tokens follow ``repro_torch.kernels.parity.compare_tokens``: equal,
  except from the first step where the reference's top-2 logit gap is
  within the logit tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import embedder as jemb_mod  # noqa: E402
from repro.core import reranker as jrr_mod  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro.core.interfaces import Chunk as JChunk  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.generator import ModelLLM, build_prompt  # noqa: E402
from repro_torch.core.interfaces import Chunk  # noqa: E402
from repro_torch.core.reranker import BiEncoderReranker  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.parity import compare_tokens, compare_topk  # noqa: E402
from repro_torch.models import api, layers, transformer  # noqa: E402

DENSE = ["llama3_8b", "phi4_mini_3_8b", "nemotron_4_15b", "mistral_large_123b"]
MOE = ["qwen3_moe_30b_a3b", "granite_moe_1b_a400m"]
# llama3 (GQA rep 2), phi4 (tied embeddings, rep 3), nemotron (sq_relu)
SMOKE_ARCHS = ["llama3_8b", "phi4_mini_3_8b", "nemotron_4_15b"]
TOL = {"float32": 1e-4, "bfloat16": 0.125}


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _pair(arch, dtype, **kw):
    jcfg = jconfigs.get_smoke(arch).replace(dtype=dtype, **kw)
    tcfg = tconfigs.get_smoke(arch).replace(dtype=dtype, **kw)
    params = JT.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, convert.transformer_from_jax(_np_tree(params), tcfg,
                                                      "cpu")


def _tokens(rng, lengths, S, vocab):
    tok = np.zeros((len(lengths), S), np.int32)
    for r, n in enumerate(lengths):
        tok[r, :n] = rng.integers(4, vocab, n)
    return tok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_transformer_matches_jax(arch, dtype):
    """forward, prefill with per-row lengths and two decode steps."""
    jcfg, params, model = _pair(arch, dtype)
    tol = TOL[dtype]
    lengths = np.array([24, 17, 9], np.int32)
    tok = _tokens(np.random.default_rng(1), lengths, 24, jcfg.vocab_size)
    jlog, _ = JT.forward(params, jcfg, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        _close(model(torch.from_numpy(tok)), jlog, tol)
        jcache = JT.init_cache(jcfg, 3, 32)
        jl, jcache = JT.prefill(params, jcfg, {"tokens": jnp.asarray(tok)},
                                jcache, lengths=jnp.asarray(lengths))
        cache = model.init_cache(3, 32)
        tl, cache = model.prefill(torch.from_numpy(tok), cache,
                                  lengths=torch.from_numpy(lengths))
        _close(tl, jl, tol)
        _close(cache["k"], jcache["k"], tol)
        _close(cache["v"], jcache["v"], tol)
        assert cache["pos"].tolist() == lengths.tolist()
        for _ in range(2):   # the reference's greedy tokens go to both
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jl, jcache = JT.decode_step(params, jcfg,
                                        {"tokens": jnp.asarray(nxt)}, jcache)
            tl, cache = model.decode_step(torch.from_numpy(nxt), cache)
            _close(tl, jl, tol)
        _close(cache["k"], jcache["k"], tol)
        assert cache["pos"].tolist() == (lengths + 2).tolist()


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_lockstep_decode_matches_jax(arch):
    """Prefill without lengths puts the whole batch at one position (an
    int), and the decode step takes the scalar index."""
    jcfg, params, model = _pair(arch, "float32")
    tok = _tokens(np.random.default_rng(2), [16, 16], 16, jcfg.vocab_size)
    jl, jcache = JT.prefill(params, jcfg, {"tokens": jnp.asarray(tok)},
                            JT.init_cache(jcfg, 2, 20))
    with torch.no_grad():
        tl, cache = model.prefill(torch.from_numpy(tok),
                                  model.init_cache(2, 20))
        assert cache["pos"] == 16
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jcache = JT.decode_step(params, jcfg, {"tokens": jnp.asarray(nxt)},
                                    jcache)
        tl, cache = model.decode_step(torch.from_numpy(nxt), cache)
    _close(tl, jl, TOL["float32"])
    _close(cache["v"], jcache["v"], TOL["float32"])
    assert cache["pos"] == 17


def test_attention_goes_through_the_kernel_dispatch(monkeypatch):
    """Every layer's full-sequence attention calls ``ops.flash_attention``
    with ``[B,H,S,dh]`` heads, causal for the model, not for encoders."""
    _, _, model = _pair("llama3_8b", "float32")
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    tok = torch.randint(4, 512, (2, 10))
    with torch.no_grad():
        model(tok)
        model.hidden(tok, causal=False)
    assert calls == [((2, 4, 10, 32), (2, 2, 10, 32), True)] * 2 + [
        ((2, 4, 10, 32), (2, 2, 10, 32), False)] * 2


def _jax_gaps(jllm, texts, ref_ids):
    """The reference's top-1 minus top-2 logit at each greedy step, from a
    full forward over each prompt and its tokens."""
    gaps = []
    for text, ids in zip(texts, ref_ids):
        prompt = jllm.tok.encode(text, jllm.max_prompt)
        seq = np.array(prompt + list(ids[:-1]), np.int32)[None]
        logits, _ = JT.forward(jllm.params, jllm.cfg,
                               {"tokens": jnp.asarray(seq)})
        top = np.sort(np.asarray(logits[0, len(prompt) - 1:], np.float32),
                      axis=1)[:, -2:]
        gaps.append(top[:, 1] - top[:, 0])
    return np.stack(gaps)


def _ids(answers):
    return np.array([[int(w[3:]) for w in a.split()] for a in answers])


def test_model_llm_generates_the_jax_tokens():
    """Six requests in batches of four: the second batch is padded past its
    two real rows, which are neither returned nor recorded."""
    cfg = jconfigs.get_smoke("llama3_8b").replace(dtype="float32")
    jllm = JModelLLM(cfg, max_prompt=48, max_new=8, batch_size=4, seed=0)
    tllm = convert.model_llm_from_jax(jllm, device="cpu")
    questions = [f"what is the color of item-{i}" for i in range(6)]
    texts = [f"the color of item-{i} is shade-{i * 7 % 5} and more words "
             * (1 + i % 3) for i in range(6)]
    jans = jllm.generate(questions, [[JChunk(i, i, t)]
                                     for i, t in enumerate(texts)])
    tans = tllm.generate(questions, [[Chunk(i, i, t)]
                                     for i, t in enumerate(texts)])
    ref = _ids(jans)
    assert ref.shape == (6, 8)
    prompts = [build_prompt(q, [Chunk(0, 0, t)])
               for q, t in zip(questions, texts)]
    got = compare_tokens(ref, _ids(tans), _jax_gaps(jllm, prompts, ref),
                         TOL["float32"])
    assert got["violations"] == 0, (got, jans, tans)
    assert tllm.stats.n_requests == jllm.stats.n_requests == 6
    assert tllm.stats.tokens_out == jllm.stats.tokens_out == 48
    assert set(jllm.stats.summary()) <= set(tllm.stats.summary())


def _fp32_encoders(monkeypatch):
    """The reference's encoders in fp32 (its encoder_config is bf16)."""
    for mod in (jemb_mod, jrr_mod):
        orig = mod.encoder_config
        monkeypatch.setattr(
            mod, "encoder_config",
            lambda _orig=orig, **kw: _orig(**kw).replace(dtype="float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_embedder_matches_jax(dtype, monkeypatch):
    if dtype == "float32":
        _fp32_encoders(monkeypatch)
    jemb = jemb_mod.TransformerEmbedder(dim=32, d_model=64, n_layers=2,
                                        max_len=24, batch_size=4)
    temb = convert.transformer_embedder_from_jax(jemb, device="cpu")
    assert temb.cfg.dtype == dtype
    texts = ["the color of item-1 is red", "", "alpha beta gamma " * 12,
             "what is the size of item-7", "one", "two three four five six"]
    want, got = jemb.embed(texts), temb.embed(texts)
    assert got.shape == (6, 32) and got.dtype == np.float32
    # unit vectors: bf16 hidden states, fp32 pooling and projection
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not got[1].any()          # an empty text has no token to pool


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_reranker_matches_jax(dtype, monkeypatch):
    """Scores and order of six candidates in batches of four."""
    if dtype == "float32":
        _fp32_encoders(monkeypatch)
    jrr = jrr_mod.CrossEncoderReranker(d_model=64, n_layers=2, max_len=48,
                                       batch_size=4)
    trr = convert.cross_reranker_from_jax(jrr, device="cpu")
    texts = [f"the size of item-{i} is {i * 3} units " * (1 + i % 4)
             for i in range(6)]
    query = "what is the size of item-2"
    want = jrr.rerank(query, [JChunk(i, 0, t) for i, t in enumerate(texts)],
                      6)
    got = trr.rerank(query, [Chunk(i, 0, t) for i, t in enumerate(texts)], 6)
    tol = 1e-5 if dtype == "float32" else 2e-2
    res = compare_topk(np.array([[s for _, s in want]]),
                       np.array([[c.chunk_id for c, _ in want]]),
                       np.array([[s for _, s in got]]),
                       np.array([[c.chunk_id for c, _ in got]]), tol)
    assert res["violations"] == 0, (want, got)


def test_bi_reranker_matches_jax():
    """The bi-encoder over the hash embedder carried across."""
    jemb = jemb_mod.HashEmbedder(dim=64, vocab_size=1024)
    want = jrr_mod.BiEncoderReranker(jemb).rerank(
        "size of item-3", [JChunk(i, 0, f"item-{i} size {i}") for i in range(5)],
        3)
    got = BiEncoderReranker(convert.embedder_from_jax(jemb)).rerank(
        "size of item-3", [Chunk(i, 0, f"item-{i} size {i}") for i in range(5)],
        3)
    assert [c.chunk_id for c, _ in got] == [c.chunk_id for c, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_matches_jax_on_meta(arch):
    """Every FULL config of the zoo: the port's count, from shapes on
    ``meta`` (nothing allocated), equals the reference's, and so do the
    active count, the bytes (bf16; an MoE's router, Mamba2's and xLSTM's
    gate leaves in fp32) and the model FLOPs."""
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    model = api.build(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert api.param_bytes(model) == japi.param_bytes(
        japi.get_model(jcfg).init_shape(jcfg))
    if cfg.moe is None and cfg.family in ("dense", "vlm", "audio"):
        assert api.param_bytes(model) == 2 * cfg.param_count()    # bf16
    for kind in ("train", "prefill", "decode"):
        assert api.model_flops(cfg, 8, 512, kind) == japi.model_flops(
            jcfg, 8, 512, kind)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_family_is_ported(arch):
    """Every id of the reference's zoo loads in the port, equal to the
    reference's config, and its family has a model module; an unknown
    family raises."""
    for get in ("get_config", "get_smoke"):
        cfg = getattr(tconfigs, get)(arch)
        assert cfg == convert.model_config(getattr(jconfigs, get)(arch))
        assert api.get_model(cfg) is api.FAMILY_MODULES[cfg.family]
    with pytest.raises(ValueError, match="unknown model family"):
        api.get_model(cfg.replace(family="retnet"))


SOFTCAP = 50.0   # Gemma 2's attention logit cap (arXiv:2408.00118)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcapped_transformer_matches_jax(dtype):
    """A dense SMOKE config with ``attn_logit_softcap = 50`` serves as the
    reference does: forward, prefill with per-row lengths and 8 decode
    steps (the cached step's capped scores) within TOL, every step fed the
    reference's greedy token; the same config without the cap differs
    from it by more than fp32's tolerance."""
    jcfg, params, model = _pair("llama3_8b", dtype,
                                attn_logit_softcap=SOFTCAP)
    tol = TOL[dtype]
    lengths = np.array([24, 17, 9], np.int32)
    tok = _tokens(np.random.default_rng(5), lengths, 24, jcfg.vocab_size)
    jlog, _ = JT.forward(params, jcfg, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        _close(model(torch.from_numpy(tok)), jlog, tol)
        if dtype == "float32":
            plain = convert.transformer_from_jax(
                _np_tree(params), model.cfg.replace(attn_logit_softcap=0.0),
                "cpu")
            assert float(np.abs(_f32(plain(torch.from_numpy(tok)))
                                - _f32(jlog)).max()) > tol
        jcache = JT.init_cache(jcfg, 3, 40)
        jl, jcache = JT.prefill(params, jcfg, {"tokens": jnp.asarray(tok)},
                                jcache, lengths=jnp.asarray(lengths))
        cache = model.init_cache(3, 40)
        tl, cache = model.prefill(torch.from_numpy(tok), cache,
                                  lengths=torch.from_numpy(lengths))
        _close(tl, jl, tol)
        for _ in range(8):
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jl, jcache = JT.decode_step(params, jcfg,
                                        {"tokens": jnp.asarray(nxt)}, jcache)
            tl, cache = model.decode_step(torch.from_numpy(nxt), cache)
            _close(tl, jl, tol)
        _close(cache["k"], jcache["k"], tol)
        assert cache["pos"].tolist() == (lengths + 8).tolist()


def test_softcapped_cross_attention_matches_jax():
    """Cross attention (``multihead_attention`` with ``kv_x``, unmasked as
    Whisper's decoder calls it) caps its scores as the reference's does,
    fp32, within TOL."""
    from repro.models import layers as JL
    jcfg = jconfigs.get_smoke("llama3_8b").replace(
        dtype="float32", attn_logit_softcap=5.0)
    cfg = tconfigs.get_smoke("llama3_8b").replace(
        dtype="float32", attn_logit_softcap=5.0)
    rng = np.random.default_rng(11)
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.5
              for k, s in layers.attn_shapes(cfg).items()}
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want = JL.multihead_attention({k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(x), None,
                                  jcfg, causal=False, kv_x=jnp.asarray(kv))
    got = layers.multihead_attention(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), None, cfg, causal=False,
        kv_x=torch.from_numpy(kv))
    _close(got, want, TOL["float32"])


def test_model_llm_factory_takes_device():
    llm = registry.create("llm", "model", arch="llama3_8b", smoke=True,
                          max_new=2, batch_size=2, device="cpu")
    assert isinstance(llm, ModelLLM) and llm.model.device.type == "cpu"
    assert llm.model.embed.dtype == torch.bfloat16
    out = llm.generate(["what is the size of item-1"],
                       [[Chunk(0, 0, "the size of item-1 is 4")]])
    assert len(out) == 1 and len(out[0].split()) == 2


def test_model_llm_without_device_needs_cuda(monkeypatch):
    """The port runs on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelLLM(tconfigs.get_smoke("llama3_8b"))


def test_transformer_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke("llama3_8b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init(cfg, 0)


def _jax_llm():
    return JModelLLM(jconfigs.get_smoke("llama3_8b"), max_prompt=16,
                     max_new=2, batch_size=2)


def _jax_embedder():
    return jemb_mod.TransformerEmbedder(dim=32, d_model=64, n_layers=2,
                                        max_len=24, batch_size=4)


def _jax_cross():
    return jrr_mod.CrossEncoderReranker(d_model=64, n_layers=2, max_len=48,
                                        batch_size=4)


@pytest.mark.parametrize("carry,make", [
    (convert.model_llm_from_jax, _jax_llm),
    (convert.transformer_embedder_from_jax, _jax_embedder),
    (convert.cross_reranker_from_jax, _jax_cross)])
def test_carried_components_without_device_need_cuda(carry, make,
                                                     monkeypatch):
    """With no device the components carried across go to the card, model
    and all, or raise where there is none: never a CPU model behind a
    component that believes it runs on the card."""
    jax_component = make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        carry(jax_component)


def test_model_refuses_inputs_on_another_device():
    """Token ids and lengths must already lie on the model's device."""
    cfg = tconfigs.get_smoke("llama3_8b").replace(dtype="float32")
    model = transformer.init(cfg, 0, "cpu")
    tok = torch.randint(4, 512, (2, 6))
    with torch.no_grad(), pytest.raises(ValueError, match="lengths"):
        model.prefill(tok, model.init_cache(2, 8), lengths=[6, 3])
    with torch.no_grad(), pytest.raises(ValueError, match="tokens"):
        transformer.Transformer(cfg, device="meta")(tok)


@pytest.mark.parametrize("component", ["llm", "embedder", "cross"])
def test_components_refuse_a_model_on_another_device(component):
    from repro_torch.core.embedder import TransformerEmbedder
    from repro_torch.core.reranker import CrossEncoderReranker
    cfg = tconfigs.get_smoke("llama3_8b")
    meta_model = transformer.Transformer(cfg, device="meta")
    build = {
        "llm": lambda: ModelLLM(cfg, device="cpu", model=meta_model),
        "embedder": lambda: TransformerEmbedder(
            dim=8, device="cpu", model=meta_model,
            proj=np.zeros((cfg.d_model, 8), np.float32)),
        "cross": lambda: CrossEncoderReranker(
            device="cpu", model=meta_model,
            head=np.zeros((cfg.d_model, 1), np.float32)),
    }[component]
    with pytest.raises(ValueError, match="its model lies on meta"):
        build()


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_model_on_the_card_matches_the_cpu(cuda_device, arch, dtype):
    """One set of weights on the CPU (plain attention) and on the card (the
    kernel: the fp32 one, or the bf16 mma one): prefill logits within the
    dtype's tolerance, greedy tokens by the near-tie rule."""
    _, _, cpu_model = _pair(arch, dtype)
    card_model = convert.transformer_from_jax(
        _np_tree(JT.init(jax.random.PRNGKey(0),
                         jconfigs.get_smoke(arch).replace(dtype=dtype))),
        cpu_model.cfg, cuda_device)
    lengths = np.array([24, 17, 9], np.int32)
    tok = torch.from_numpy(_tokens(np.random.default_rng(3), lengths, 24,
                                   cpu_model.cfg.vocab_size))
    with torch.no_grad():
        want, wc = cpu_model.prefill(tok, cpu_model.init_cache(3, 32),
                                     lengths=torch.from_numpy(lengths))
        ops.reset_launch_counts()
        got, gc = card_model.prefill(tok.to(cuda_device),
                                     card_model.init_cache(3, 32),
                                     lengths=torch.from_numpy(lengths).to(
                                         cuda_device))
        assert ops.launch_counts()["flash_attention"] == cpu_model.cfg.n_layers
        _close(got.cpu(), want, TOL[dtype])
        ref_ids, ids, gaps = [], [], []
        for _ in range(4):
            top = want.float().topk(2).values
            gaps.append((top[:, 0] - top[:, 1]).numpy())
            ref_ids.append(want.argmax(-1))
            ids.append(got.argmax(-1).cpu())
            want, wc = cpu_model.decode_step(ref_ids[-1][:, None], wc)
            got, gc = card_model.decode_step(ids[-1][:, None].to(cuda_device),
                                             gc)
    res = compare_tokens(torch.stack(ref_ids, 1), torch.stack(ids, 1),
                         np.stack(gaps, 1), TOL[dtype])
    assert res["violations"] == 0, res
