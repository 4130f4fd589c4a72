"""The port's other model families against the JAX package's, on the CPU:
the vlm backbone (Qwen2-VL, M-RoPE), the audio encoder-decoder (Whisper),
the ssm (xLSTM) and the hybrid (Zamba2 over Mamba2).

The reference's parameters (each family's ``init`` at the SMOKE config, in
fp32) go across with ``repro_torch.convert``; the same seeded numpy inputs
go through both, the JAX side jitted on the CPU. Tolerance: 1e-4 on logits
and caches (``TOL["float32"]`` of ``tests/test_torch_models.py``: the
products and scans sum in other orders). Greedy tokens follow
``compare_tokens``: equal, except from a step where the reference's top-2
logit gap is within the tolerance.

The ``cuda``-marked tests hold each family on the card (the attention
kernel where the family has one) against the CPU; they skip without a card.
"""
import dataclasses
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro.core.interfaces import Chunk as JChunk  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.interfaces import Chunk  # noqa: E402
from repro_torch.core.spec import PipelineSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.parity import compare_tokens  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ZOO = ["qwen2_vl_72b", "whisper_large_v3", "xlstm_1_3b", "zamba2_2_7b"]
TOL = 1e-4
STEPS = 8


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _pair(arch, dtype="float32", **over):
    """(reference config, reference params, the port's model on the CPU
    holding them)."""
    jcfg = jconfigs.get_smoke(arch).replace(dtype=dtype, **over)
    params = japi.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    model = convert.model_from_jax(_np_tree(params),
                                   convert.model_config(jcfg), "cpu")
    return jcfg, params, model


def _jit(jcfg, name):
    return jax.jit(partial(getattr(japi.get_model(jcfg), name), cfg=jcfg))


class Inputs:
    """One family's seeded inputs: the reference's batch dict and the
    port's arguments, for a prompt of ``S`` tokens (or embeddings)."""

    def __init__(self, jcfg, B, S, seed=1):
        rng = np.random.default_rng(seed)
        self.cfg = jcfg
        self.tokens = rng.integers(4, jcfg.vocab_size, (B, S)).astype(np.int32)
        self.embeds = rng.standard_normal((B, S, jcfg.d_model)).astype(
            np.float32)
        self.frames = rng.standard_normal(
            (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)

    def jax(self):
        fam = self.cfg.family
        if fam == "vlm":
            return {"embeds": jnp.asarray(self.embeds)}
        batch = {"tokens": jnp.asarray(self.tokens)}
        if fam == "audio":
            batch["frames"] = jnp.asarray(self.frames)
        return batch

    def first(self):
        """The port's primary input: ids, or the vlm's embeddings."""
        if self.cfg.family == "vlm":
            return torch.from_numpy(self.embeds)
        return torch.from_numpy(self.tokens)

    def extra(self):
        if self.cfg.family == "audio":
            return {"frames": torch.from_numpy(self.frames)}
        return {}


def _leaves(tree):
    return jax.tree.leaves(tree)


def _port_leaves(cache):
    """The port cache's tensors in the reference's leaf order (its dicts
    sort their keys as JAX's do; ``pos`` is compared on its own)."""
    out = []
    for key in sorted(cache):
        v = cache[key]
        if key == "pos":
            continue
        if isinstance(v, dict):
            out += [v[k] for k in sorted(v)]
        elif isinstance(v, tuple):
            out += list(v)
        else:
            out.append(v)
    return out


def _close_caches(cache, jcache):
    jl = [leaf for leaf in _leaves({k: v for k, v in jcache.items()
                                    if k != "pos"})]
    tl = _port_leaves(cache)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    assert np.array_equal(np.asarray(cache["pos"]), np.asarray(jcache["pos"]))


def _step_input(jcfg, nxt, rng):
    """A decode step's input: the greedy ids, or for the vlm seeded random
    embeddings."""
    if jcfg.family == "vlm":
        e = rng.standard_normal((nxt.shape[0], 1, jcfg.d_model)).astype(
            np.float32)
        return {"embeds": jnp.asarray(e)}, torch.from_numpy(e)
    return {"tokens": jnp.asarray(nxt)}, torch.from_numpy(nxt)


@pytest.mark.parametrize("arch,over", [(a, {}) for a in ZOO] + [
    ("xlstm_1_3b", {"mlstm_chunk": 8})])
def test_zoo_forward_matches_jax(arch, over):
    """Full-sequence logits (xLSTM also chunkwise, 3 chunks of 8)."""
    jcfg, params, model = _pair(arch, **over)
    S = 24 if arch != "zamba2_2_7b" else 32     # zamba2: a multiple of its chunk
    inp = Inputs(jcfg, 2, S)
    want, _ = _jit(jcfg, "forward")(params, batch=inp.jax())
    with torch.no_grad():
        got = model(inp.first(), **inp.extra())
    assert got.shape == (2, S, jcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_prefill_and_decode_match_jax(arch):
    """Prefill's last logits and every cache leaf, then STEPS decode steps
    fed the reference's greedy tokens (the vlm: seeded embeddings) and the
    caches again. The vlm prefills with per-row lengths, as ``ModelLLM``
    runs it; the other families lock-step."""
    jcfg, params, model = _pair(arch)
    S, B = 32, 3
    inp = Inputs(jcfg, B, S)
    max_len = S + STEPS + 2
    jcache = japi.get_model(jcfg).init_cache(jcfg, B, max_len)
    cache = model.init_cache(B, max_len)
    kw, tkw = {}, inp.extra()
    if jcfg.family == "vlm":
        lengths = np.array([32, 17, 5], np.int32)
        kw["lengths"] = jnp.asarray(lengths)
        tkw["lengths"] = torch.from_numpy(lengths)
    jl, jcache = _jit(jcfg, "prefill")(params, batch=inp.jax(), cache=jcache,
                                       **kw)
    decode = _jit(jcfg, "decode_step")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        tl, cache = model.prefill(inp.first(), cache, **tkw)
        _close(tl, jl)
        _close_caches(cache, jcache)
        for _ in range(STEPS):
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jb, tb = _step_input(jcfg, nxt, rng)
            jl, jcache = decode(params, batch=jb, cache=jcache)
            tl, cache = model.decode_step(tb, cache)
            _close(tl, jl)
    _close_caches(cache, jcache)


def _positions_3d(B, S, seed=2):
    """Three distinct position streams (temporal, height, width), as a
    patch grid gives them."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(S), (B, S))
    h = rng.integers(0, 8, (B, S))
    w = rng.integers(0, 16, (B, S))
    return np.stack([t, h, w]).astype(np.int32)


def test_apply_mrope_matches_jax():
    """M-RoPE with distinct streams is not RoPE; with equal streams it is."""
    cfg = jconfigs.get_smoke("qwen2_vl_72b")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 4, 32)).astype(np.float32)
    p3 = _positions_3d(2, 10)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(p3), cfg.rope_theta,
                          cfg.mrope_sections)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3),
                             cfg.rope_theta, cfg.mrope_sections)
    _close(got, want, 1e-5)
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(p3[0]),
                             cfg.rope_theta)
    assert not torch.allclose(got, rope, atol=1e-3)
    text = np.ascontiguousarray(np.broadcast_to(p3[0], (3, 2, 10)))
    same = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text),
                              cfg.rope_theta, cfg.mrope_sections)
    assert torch.equal(same, rope)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text),
                           cfg.rope_theta, (4, 6, 5))


def test_vlm_distinct_position_streams_match_jax():
    """Qwen2-VL's forward and prefill (logits and the M-RoPE-rotated cached
    keys) with three distinct position streams."""
    jcfg, params, model = _pair("qwen2_vl_72b")
    inp = Inputs(jcfg, 2, 20)
    p3 = _positions_3d(2, 20)
    batch = dict(inp.jax(), positions_3d=jnp.asarray(p3))
    want, _ = _jit(jcfg, "forward")(params, batch=batch)
    jl, jcache = _jit(jcfg, "prefill")(
        params, batch=batch,
        cache=japi.get_model(jcfg).init_cache(jcfg, 2, 24))
    with torch.no_grad():
        got = model(inp.first(), positions_3d=torch.from_numpy(p3))
        tl, cache = model.prefill(inp.first(), model.init_cache(2, 24),
                                  positions_3d=torch.from_numpy(p3))
        plain = model(inp.first())
    _close(got, want)
    _close(tl, jl)
    _close_caches(cache, jcache)
    assert not np.allclose(_f32(plain), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("S,steps", [(96, 8), (32, 40)])
def test_zamba2_window_ring_buffer_matches_jax(S, steps):
    """Past the SMOKE window of 64: a prompt longer than the window (the
    prefill keeps its last 64 entries rolled to slot position % 64) and a
    decode that crosses position 64 (every slot valid from there)."""
    jcfg, params, model = _pair("zamba2_2_7b")
    assert jcfg.attn_window == 64
    inp = Inputs(jcfg, 2, S)
    max_len = S + steps
    jcache = japi.get_model(jcfg).init_cache(jcfg, 2, max_len)
    cache = model.init_cache(2, max_len)
    assert cache["k"].shape[2] == 64
    jl, jcache = _jit(jcfg, "prefill")(params, batch=inp.jax(), cache=jcache)
    decode = _jit(jcfg, "decode_step")
    with torch.no_grad():
        tl, cache = model.prefill(inp.first(), cache)
        _close(tl, jl)
        _close_caches(cache, jcache)
        for _ in range(steps):
            nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
            jl, jcache = decode(params, batch={"tokens": jnp.asarray(nxt)},
                                cache=jcache)
            tl, cache = model.decode_step(torch.from_numpy(nxt), cache)
            _close(tl, jl)
    _close_caches(cache, jcache)
    assert cache["pos"] == S + steps


def test_whisper_cross_cache_and_decode_positions():
    """The encoder's projected K/V in the cross cache equal the reference's,
    and each decode step at index i (its sinusoidal position) gives the
    logits a full forward gives at position i, at indices 12 to 19."""
    jcfg, params, model = _pair("whisper_large_v3")
    inp = Inputs(jcfg, 2, 20)
    jcache = japi.get_model(jcfg).init_cache(jcfg, 2, 24)
    short = Inputs(jcfg, 2, 12)
    short.tokens, short.frames = inp.tokens[:, :12], inp.frames
    _, jcache = _jit(jcfg, "prefill")(params, batch=short.jax(), cache=jcache)
    with torch.no_grad():
        full = model(inp.first(), frames=torch.from_numpy(inp.frames))
        _, cache = model.prefill(short.first(), model.init_cache(2, 24),
                                 frames=torch.from_numpy(inp.frames))
        for name in ("cross_k", "cross_v"):
            assert cache[name].shape == (jcfg.n_layers, 2, jcfg.encoder_seq,
                                         jcfg.n_kv_heads,
                                         jcfg.resolved_head_dim)
            _close(cache[name], jcache[name])
        for i in range(12, 20):
            tl, cache = model.decode_step(
                torch.from_numpy(inp.tokens[:, i:i + 1]), cache)
            _close(tl, full[:, i])


def _rag_requests():
    questions = [f"what is the color of item-{i}" for i in range(6)]
    texts = [f"the color of item-{i} is shade-{i * 7 % 5} and more words "
             * (1 + i % 3) for i in range(6)]
    return questions, texts


def _ids(answers):
    return np.array([[int(w[3:]) for w in a.split()] for a in answers])


def _jax_gaps(jllm, texts, ref_ids):
    """The reference's top-1 minus top-2 logit at each greedy step: each
    prompt alone through its own ``ModelLLM``'s jitted prefill and decode
    (a batch row's logits do not depend on the other rows)."""
    from repro.core.generator import build_prompt as jbuild
    gaps = []
    for (q, t), ids in zip(texts, ref_ids):
        tokens = jllm.tok.encode_batch([jbuild(q, [JChunk(0, 0, t)])],
                                       jllm.max_prompt)
        cache = jllm.model.init_cache(jllm.cfg, 1,
                                      jllm.max_prompt + jllm.max_new)
        kw = {}
        if jllm._per_row_pos:
            kw["lengths"] = jnp.asarray(np.maximum((tokens != 0).sum(1), 1)
                                        .astype(np.int32))
        logits, cache = jllm._prefill(jllm.params,
                                      batch=jllm._make_batch(tokens),
                                      cache=cache, **kw)
        row = []
        for tok in list(ids[:-1]) + [None]:
            top = np.sort(np.asarray(logits[0], np.float32))[-2:]
            row.append(top[1] - top[0])
            if tok is not None:
                logits, cache = jllm._decode(
                    jllm.params, batch={"tokens": jnp.asarray([[tok]],
                                                              jnp.int32)},
                    cache=cache)
        gaps.append(row)
    return np.array(gaps)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_model_llm_generates_the_jax_tokens(arch):
    """``ModelLLM`` end to end through ``model_llm_from_jax`` on six RAG
    prompts in batches of four (the second padded past its two real
    rows): the reference ``ModelLLM``'s tokens. The vlm's stub frontend
    gives zero embeddings, so both generate token 0 throughout."""
    cfg = jconfigs.get_smoke(arch).replace(dtype="float32")
    jllm = JModelLLM(cfg, max_prompt=64, max_new=STEPS, batch_size=4, seed=0)
    tllm = convert.model_llm_from_jax(jllm, device="cpu")
    questions, texts = _rag_requests()
    jans = jllm.generate(questions, [[JChunk(i, i, t)]
                                     for i, t in enumerate(texts)])
    tans = tllm.generate(questions, [[Chunk(i, i, t)]
                                     for i, t in enumerate(texts)])
    ref, got = _ids(jans), _ids(tans)
    assert ref.shape == got.shape == (6, STEPS)
    if cfg.family == "vlm":
        assert (ref == 0).all() and np.array_equal(got, ref)
    else:
        res = compare_tokens(ref, got, _jax_gaps(
            jllm, list(zip(questions, texts)), ref), TOL)
        assert res["violations"] == 0, (res, jans, tans)
    assert tllm.stats.n_requests == jllm.stats.n_requests == 6
    assert tllm.stats.tokens_out == jllm.stats.tokens_out == 6 * STEPS


def _spy(monkeypatch):
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal, window=0, softcap=0.0):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return real(q, k, v, causal=causal, window=window, softcap=softcap)

    monkeypatch.setattr(ops, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("arch,over", [
    ("qwen2_vl_72b", {}), ("whisper_large_v3", {}), ("xlstm_1_3b", {}),
    ("zamba2_2_7b", {}), ("zamba2_2_7b", {"attn_window": 4096})])
def test_zoo_prefill_goes_through_the_kernel_dispatch(arch, over,
                                                      monkeypatch):
    """Every prefill attention layer calls ``ops.flash_attention`` with
    ``[B,H,S,dh]`` heads: Qwen2-VL's layers causal; Whisper's encoder (not
    causal, S = encoder_seq) then decoder (causal) layers; Zamba2's shared
    block once a group with the config's window (64 at SMOKE, 4,096 as
    FULL sets it); xLSTM none."""
    jcfg, _, model = _pair(arch, **over)
    calls = _spy(monkeypatch)
    B, S = 2, 32
    inp = Inputs(jcfg, B, S)
    with torch.no_grad():
        model.prefill(inp.first(), model.init_cache(B, S + 4), **inp.extra())
    H, hkv, hd = jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim
    step = ((B, H, S, hd), (B, hkv, S, hd), True, jcfg.attn_window)
    enc = ((B, H, jcfg.encoder_seq, hd), (B, hkv, jcfg.encoder_seq, hd),
           False, 0)
    n_calls = {"vlm": jcfg.n_layers, "audio": jcfg.n_layers, "ssm": 0,
               "hybrid": jcfg.n_layers // max(jcfg.shared_attn_every, 1)}
    want = ([enc] * jcfg.encoder_layers if jcfg.family == "audio" else []) \
        + [step] * n_calls[jcfg.family]
    assert calls == want


SPECS = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                     "specs")


@pytest.mark.parametrize("arch", ZOO)
def test_serve_runs_each_family_on_cpu(arch):
    """``serve --arch <id> --smoke`` puts each family's ModelLLM in the
    llm slot of the fused IVF spec; closed-loop at concurrency 4 every
    request is answered with its tokens. Each family's spec
    (``model_<arch>.json``, but Qwen2-VL's: 72B does not fit one card) is
    the Llama-3-8B spec with the arch swapped."""
    doc = serve.main(["--config", os.path.join(SPECS, "fused_ivf.json"),
                      "--arch", arch, "--smoke", "--max-new", "3", "--docs",
                      "16", "--requests", "10", "--mode", "closed",
                      "--concurrency", "4", "--device", "cpu"])
    assert doc["summary"]["n_failed"] == 0
    assert doc["gen"]["n_requests"] == doc["summary"]["n_queries"] > 0
    assert doc["gen"]["tokens_out"] == 3 * doc["gen"]["n_requests"]
    if arch == "qwen2_vl_72b":
        return
    llama = PipelineSpec.from_file(os.path.join(SPECS,
                                                "model_llama3_8b.json"))
    spec = PipelineSpec.from_file(os.path.join(SPECS, f"model_{arch}.json"))
    assert spec.llm.options == dict(llama.llm.options, arch=arch)
    assert dataclasses.replace(spec, llm=llama.llm) == llama


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# flash_attention launches of one prefill at SMOKE
SMOKE_FLASH = {"qwen2_vl_72b": 2, "whisper_large_v3": 4, "xlstm_1_3b": 0,
               "zamba2_2_7b": 2}
CARD_TOL = {"float32": 1e-4, "bfloat16": 0.125}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_model_on_the_card_matches_the_cpu(cuda_device, arch, dtype):
    """One set of weights on the CPU (plain attention) and on the card (the
    kernel where the family has attention): prefill logits within the
    dtype's tolerance, greedy tokens by the near-tie rule."""
    jcfg, params, cpu_model = _pair(arch, dtype)
    card_model = convert.model_from_jax(_np_tree(params), cpu_model.cfg,
                                        cuda_device)
    inp = Inputs(jcfg, 3, 32, seed=3)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        extra = inp.extra()
        want, wc = cpu_model.prefill(inp.first(), cpu_model.init_cache(3, 48),
                                     **extra)
        ops.reset_launch_counts()
        got, gc = card_model.prefill(
            inp.first().to(cuda_device), card_model.init_cache(3, 48),
            **{k: v.to(cuda_device) for k, v in extra.items()})
        assert ops.launch_counts()["flash_attention"] == SMOKE_FLASH[arch]
        _close(got.cpu(), want, CARD_TOL[dtype])
        ref_ids, ids, gaps = [], [], []
        for _ in range(4):
            top = want.float().topk(2).values
            gaps.append((top[:, 0] - top[:, 1]).numpy())
            ref_ids.append(want.argmax(-1))
            ids.append(got.argmax(-1).cpu())
            if jcfg.family == "vlm":
                e = torch.from_numpy(rng.standard_normal(
                    (3, 1, jcfg.d_model)).astype(np.float32))
                want, wc = cpu_model.decode_step(e, wc)
                got, gc = card_model.decode_step(e.to(cuda_device), gc)
            else:
                want, wc = cpu_model.decode_step(ref_ids[-1][:, None], wc)
                got, gc = card_model.decode_step(
                    ids[-1][:, None].to(cuda_device), gc)
    res = compare_tokens(torch.stack(ref_ids, 1), torch.stack(ids, 1),
                         np.stack(gaps, 1), CARD_TOL[dtype])
    assert res["violations"] == 0, res


@pytest.mark.cuda
def test_model_llm_factory_builds_every_family_on_the_card(cuda_device):
    from repro_torch.core import registry
    for arch in ZOO:
        llm = registry.create("llm", "model", arch=arch, smoke=True,
                              max_prompt=64, max_new=2, batch_size=2)
        out = llm.generate(["what is the size of item-1"],
                           [[Chunk(0, 0, "the size of item-1 is 4")]])
        assert len(out) == 1 and len(out[0].split()) == 2
