"""The port's attention kernel layer against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``flash_attention_pallas`` (interpret
mode, at the block sizes of ``tests/test_kernels.py``), the JAX
``ref.flash_attention`` and the port's ``ops.flash_attention``, which runs
the plain version (``repro_torch.kernels.ref.flash_attention``) for CPU
tensors. Tolerance, as the reference's own kernel test states it: 2e-3 in
fp32 (summation order), 2e-2 in bf16 (the probabilities and the output are
rounded to bf16 at different places).

The ``cuda``-marked tests hold the hand-written kernel against the plain
version on the card; they need a card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(rng, B, H, Hkv, S, dh):
    return (rng.standard_normal((B, H, S, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrays]


def _f32(x):
    return np.asarray(x.float().cpu() if hasattr(x, "float") else
                      np.asarray(x, np.float32), np.float32)


# the shapes of tests/test_kernels.py::test_flash_attention_matches_oracle
@pytest.mark.parametrize("B,H,Hkv,S,dh,causal,dtype", [
    (1, 2, 2, 64, 16, True, "float32"),
    (2, 4, 2, 128, 32, True, "float32"),
    (2, 4, 1, 128, 64, False, "float32"),
    (1, 8, 8, 256, 32, True, "bfloat16"),
])
def test_flash_attention_matches_jax(B, H, Hkv, S, dh, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _qkv(np.random.default_rng(B * 100 + S), B, H, Hkv, S, dh)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    want_pallas = flash_attention_pallas(jq, jk, jv, causal=causal, bq=64,
                                         bk=64, interpret=True)
    want_ref = jref.flash_attention(jq, jk, jv, causal=causal)
    ops.reset_launch_counts()
    got = ops.flash_attention(*_torch(arrays, tdt), causal=causal)
    plain = ref.flash_attention(*_torch(arrays, tdt), causal=causal)
    assert ops.launch_counts()["flash_attention"] == 0   # CPU: plain version
    assert got.dtype == tdt and got.shape == (B, H, S, dh)
    assert torch.equal(got, plain)
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,Hkv,S,dh,causal", [
    (1, 3, 1, 1, 16, True), (2, 3, 1, 63, 32, True), (1, 4, 1, 65, 64, False),
    (2, 4, 4, 65, 16, True), (1, 8, 2, 192, 128, False)])
def test_flash_attention_edge_shapes_match_jax_ref(B, H, Hkv, S, dh, causal):
    """Sequence lengths off the tile size and GQA groups of 1, 3 and 4: the
    plain version against the JAX reference in fp32."""
    arrays = _qkv(np.random.default_rng(S * 10 + H), B, H, Hkv, S, dh)
    want = jref.flash_attention(*(jnp.asarray(a) for a in arrays),
                                causal=causal)
    got = ops.flash_attention(*_torch(arrays, torch.float32), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_first_row_equals_v0(dtype):
    """Causal attention at position 0 returns exactly v[0] of the query
    head's KV head."""
    _, tdt, _ = DTYPES[dtype]
    q, k, v = _torch(_qkv(np.random.default_rng(0), 2, 6, 2, 64, 16), tdt)
    out = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(out[:, :, 0], v.repeat_interleave(3, dim=1)[:, :, 0])


def _head_views(rng, B, S, H, Hkv, dh, dtype, device="cpu"):
    """q [B,H,S,dh] and k, v [B,Hkv,S,dh] as the model passes them:
    transposed views of one [B, S, H + 2 Hkv, dh] activation, unit stride
    in dh, not contiguous."""
    x = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, dh)).astype(np.float32)).to(device=device,
                                                         dtype=dtype)
    return (x[:, :, :H].transpose(1, 2), x[:, :, H:H + Hkv].transpose(1, 2),
            x[:, :, H + Hkv:].transpose(1, 2))


@pytest.mark.parametrize("B,H,Hkv,S,dh,causal,dtype", [
    (2, 4, 2, 65, 64, True, "float32"), (1, 8, 2, 130, 128, False, "float32"),
    (2, 4, 1, 33, 64, True, "bfloat16")])
def test_flash_attention_strided_views(B, H, Hkv, S, dh, causal, dtype):
    """q/k/v as transposed views (the model's call site passes them without
    a copy): the same result as on contiguous copies, and as the JAX
    reference."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _head_views(np.random.default_rng(S + dh), B, S, H, Hkv, dh,
                          tdt)
    assert not q.is_contiguous() and q.stride(3) == 1
    got = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal))
    want = jref.flash_attention(*(jnp.asarray(_f32(t), jdt) for t in
                                  (q, k, v)), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dh", [8, 24, 80, 96, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_any_head_dim_matches_jax(dh, dtype):
    """Head dims off the kernel's widths (24 is the granite smoke config's,
    80 zamba2's): the plain version against the JAX reference. In fp32,
    the card's wrapper's padding is exact: q, k, v zero-padded to
    ``padded_head_dim(dh)`` and scored at the true dh's scale (q scaled by
    sqrt(width / dh) for the plain version, which scales by its width)
    give the same output in the true columns and zeros past them."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _qkv(np.random.default_rng(dh), 2, 4, 2, 40, dh)
    want = jref.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                causal=True)
    got = ops.flash_attention(*_torch(arrays, tdt), causal=True)
    assert got.shape == (2, 4, 40, dh)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    width = tfa.padded_head_dim(dh)
    assert width in tfa.HEAD_DIMS and width >= dh
    if dtype == "float32":
        q, k, v = (torch.nn.functional.pad(t, (0, width - dh))
                   for t in _torch(arrays, tdt))
        padded = ref.flash_attention(q * (width / dh) ** 0.5, k, v,
                                     causal=True)
        np.testing.assert_allclose(padded[..., :dh].numpy(), got.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert (padded[..., dh:] == 0).all()


def _jax_window_attention(q, k, v, window, causal):
    """The reference model's attention core, ``L.multihead_attention`` with
    its ``attention_scores_mask``, on heads ``q [B,H,S,dh]``, ``k, v
    [B,Hkv,S,dh]`` (numpy): x holds q's heads, so ``wq`` and ``wo`` are
    identities, and ``wk``/``wv`` read k and v off columns appended to x."""
    from repro import configs as jconfigs
    from repro.models import layers as JL
    B, H, S, dh = q.shape
    hkv = k.shape[1]
    D = H * dh
    cfg = jconfigs.get_smoke("llama3_8b").replace(
        n_heads=H, n_kv_heads=hkv, d_model=D, head_dim=dh, dtype="float32",
        rope_type="none")
    x = np.concatenate([q.transpose(0, 2, 1, 3).reshape(B, S, D),
                        k.transpose(0, 2, 1, 3).reshape(B, S, hkv * dh),
                        v.transpose(0, 2, 1, 3).reshape(B, S, hkv * dh)], -1)
    width = x.shape[-1]
    pick = np.eye(width, dtype=np.float32)
    params = {"wq": pick[:, :D], "wk": pick[:, D:D + hkv * dh],
              "wv": pick[:, D + hkv * dh:], "wo": np.eye(D, dtype=np.float32)}
    out = JL.multihead_attention(
        {n: jnp.asarray(w) for n, w in params.items()}, jnp.asarray(x),
        jnp.zeros((B, S), jnp.int32), cfg, causal=causal, use_rope=False,
        window=window)
    return np.asarray(out).reshape(B, S, H, dh).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("S", [63, 64, 200])
@pytest.mark.parametrize("window", [1, 16, 64])
def test_flash_attention_window_matches_jax(window, S, group):
    """The sliding window (key ``j`` visible to query ``i`` iff ``j <= i``
    and ``j > i - window``): the plain version, through the dispatch, against
    the reference model's masked einsum attention in fp32."""
    H = 4
    arrays = _qkv(np.random.default_rng(window * 1000 + S + group), 2, H,
                  H // group, S, 16)
    want = _jax_window_attention(*arrays, window, True)
    ops.reset_launch_counts()
    got = ops.flash_attention(*_torch(arrays, torch.float32), causal=True,
                              window=window)
    assert ops.launch_counts()["flash_attention"] == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if window == 1:   # each row sees only its own key
        v = torch.from_numpy(arrays[2]).repeat_interleave(group, dim=1)
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_at_least_S_is_no_window(causal):
    """A window as long as the sequence masks nothing; 0 is no window."""
    q, k, v = _torch(_qkv(np.random.default_rng(7), 1, 4, 2, 50, 16),
                     torch.float32)
    full = ref.flash_attention(q, k, v, causal=causal)
    for window in (0, 50, 4096):
        assert torch.equal(ref.flash_attention(q, k, v, causal=causal,
                                               window=window), full)
    want = _jax_window_attention(*(t.numpy() for t in (q, k, v)), 8, causal)
    got = ops.flash_attention(q, k, v, causal=causal, window=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,S,dh,causal,dtype", [
    (1, 2, 2, 64, 16, True, "float32"), (2, 4, 2, 128, 32, True, "float32"),
    (2, 4, 1, 128, 64, False, "float32"), (1, 8, 8, 256, 32, True, "bfloat16"),
    (1, 3, 1, 1, 16, True, "bfloat16"), (2, 3, 1, 63, 32, True, "bfloat16"),
    (1, 4, 1, 65, 64, False, "bfloat16"), (2, 8, 2, 192, 128, True,
                                            "bfloat16"),
    (2, 8, 2, 192, 128, False, "float32"), (1, 12, 3, 65, 128, True,
                                             "float32")])
def test_flash_kernel_matches_plain(cuda_device, B, H, Hkv, S, dh, causal,
                                    dtype):
    _, tdt, tol = DTYPES[dtype]
    args = _torch(_qkv(np.random.default_rng(S + dh), B, H, Hkv, S, dh), tdt,
                  cuda_device)
    ops.reset_launch_counts()
    got = ops.flash_attention(*args, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(*args, causal=causal)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_first_row_equals_v0(cuda_device, dtype):
    _, tdt, _ = DTYPES[dtype]
    q, k, v = _torch(_qkv(np.random.default_rng(0), 2, 6, 2, 130, 64), tdt,
                     cuda_device)
    out = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(out[:, :, 0], v.repeat_interleave(3, dim=1)[:, :, 0])


ATTN_ROW_REL_LIMIT = 3e-2   # chip_smoke.py's worst-row limit (bf16)


def _row_rel_err(got, want) -> float:
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 192, 500, 512])
def test_flash_wgmma_matches_plain(cuda_device, S, group, dh, causal):
    """The Hopper kernel (bf16, dh 64/128) against the plain version on
    lengths around its 128-row tiles, GQA groups of 1, 2 and 4: within
    ATTN_TOL and the worst-row limit, causal row 0 exactly v[0], no NaN."""
    _, tdt, tol = DTYPES["bfloat16"]
    H = 4
    args = _torch(_qkv(np.random.default_rng(S * 7 + dh + group), 2, H,
                       H // group, S, dh), tdt, cuda_device)
    ops.reset_launch_counts()
    got = ops.flash_attention(*args, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(*args, causal=causal)
    assert not bool(got.isnan().any())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    assert _row_rel_err(got, want) <= ATTN_ROW_REL_LIMIT
    if causal:
        assert torch.equal(got[:, :, 0],
                           args[2].repeat_interleave(group, dim=1)[:, :, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dh,causal", [(64, False), (128, True)])
def test_flash_wgmma_strided_views(cuda_device, dh, causal):
    """The kernel reads transposed q/k/v views through its tensor maps:
    equal to the call on contiguous copies. A dense q (the model's: a
    [B,S,H,dh] activation read as [B,H,S,dh]) gets its output in q's
    layout."""
    q, k, v = _head_views(np.random.default_rng(dh), 3, 200, 8, 2, dh,
                          torch.bfloat16, cuda_device)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)
    assert torch.equal(got, want)
    dense = q.contiguous().transpose(1, 2).contiguous().transpose(1, 2)
    assert not dense.is_contiguous()
    out = ops.flash_attention(dense, k, v, causal=causal)
    assert out.stride() == dense.stride()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_flash_wgmma_refuses_other_cards(cuda_device, monkeypatch):
    """The wgmma path raises on a card that is not sm_90; it never runs the
    mma.sync kernel instead."""
    monkeypatch.setattr(tfa, "_card", lambda index: ((8, 0), "A100"))
    args = _torch(_qkv(np.random.default_rng(0), 1, 2, 2, 64, 64),
                  torch.bfloat16, cuda_device)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="sm_90"):
        ops.flash_attention(*args, causal=True)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 24, 80, 96, 200, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_any_head_dim(cuda_device, dh, dtype, causal):
    """Any dh <= 256 on the card: zero-padded to the next instantiated
    width with the true dh's softmax scale (a wrong scale moves every
    score), against the plain version at the true dh."""
    _, tdt, tol = DTYPES[dtype]
    args = _torch(_qkv(np.random.default_rng(dh + causal), 2, 6, 2, 130,
                       dh), tdt, cuda_device)
    ops.reset_launch_counts()
    got = ops.flash_attention(*args, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.shape == (2, 6, 130, dh) and got.dtype == tdt
    want = ref.flash_attention(*args, causal=causal)
    assert not bool(got.isnan().any())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        assert _row_rel_err(got, want) <= ATTN_ROW_REL_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,dtype", [(64, "bfloat16"), (128, "bfloat16"),
                                      (80, "bfloat16"), (32, "bfloat16"),
                                      (64, "float32"), (16, "float32")])
@pytest.mark.parametrize("S,window,group", [
    (63, 1, 1), (65, 17, 4), (200, 64, 1), (1000, 17, 8), (1000, 64, 4),
    (1000, 4096, 1), (300, 129, 2)])
def test_flash_kernel_window_matches_plain(cuda_device, S, window, group, dh,
                                           dtype, causal):
    """The window in all three kernels (bf16 at dh 64/128/80 on wgmma, at
    dh 32 on mma.sync, fp32 on FMAs) against the plain version: within
    ATTN_TOL and, in bf16, the worst-row limit; no NaN."""
    _, tdt, tol = DTYPES[dtype]
    H = 8
    args = _torch(_qkv(np.random.default_rng(S + window + dh), 1, H,
                       H // group, S, dh), tdt, cuda_device)
    ops.reset_launch_counts()
    got = ops.flash_attention(*args, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(*args, causal=causal, window=window)
    assert not bool(got.isnan().any())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        assert _row_rel_err(got, want) <= ATTN_ROW_REL_LIMIT
    if window == 1 and causal:
        assert torch.equal(got, args[2].repeat_interleave(group, dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_window_zero_equals_no_window(cuda_device, dtype):
    """window=0 runs the kernel without a window: bit for bit the call
    without the argument."""
    _, tdt, _ = DTYPES[dtype]
    args = _torch(_qkv(np.random.default_rng(3), 2, 8, 2, 300, 64), tdt,
                  cuda_device)
    assert torch.equal(ops.flash_attention(*args, causal=True, window=0),
                       ops.flash_attention(*args, causal=True))


# -- the gradient ---------------------------------------------------------------

import jax  # noqa: E402


@pytest.mark.parametrize("B,H,Hkv,S,dh,causal", [
    (1, 2, 2, 64, 16, True), (2, 3, 1, 37, 24, True), (2, 6, 2, 65, 80, False),
    (1, 8, 2, 33, 64, True), (1, 3, 3, 1, 16, True)])
def test_flash_attention_grad_matches_jax(B, H, Hkv, S, dh, causal):
    """The gradient of ``ops.flash_attention`` on the CPU (plain autograd of
    the plain version) against ``jax.grad`` of the reference's attention,
    fp32, from the same inputs and output gradient: within 1e-5 (the sums'
    order)."""
    rng = np.random.default_rng(S * 3 + dh)
    arrays = _qkv(rng, B, H, Hkv, S, dh)
    g = rng.standard_normal((B, H, S, dh)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(
        jref.flash_attention(q, k, v, causal=causal) * g),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    leaves = [t.requires_grad_() for t in _torch(arrays, torch.float32)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, causal=causal),
                              leaves, torch.from_numpy(g))
    assert ops.launch_counts()["flash_attention_bwd"] == 0   # CPU: plain
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 7, 40])
@pytest.mark.parametrize("H,Hkv,S,dh", [(4, 2, 33, 24), (6, 2, 65, 16),
                                        (3, 1, 1, 8)])
def test_plain_backward_matches_autograd(H, Hkv, S, dh, causal, window):
    """``ref.flash_attention_bwd`` (the backward kernel's plain version,
    from the output and ``ref.attention_lse``) against autograd of
    ``ref.flash_attention`` in fp64 inputs, any window and GQA group:
    within 1e-5 (the log-sum-exp and the probabilities are fp32)."""
    rng = np.random.default_rng(S + window + H)
    arrays = [a.astype(np.float64) for a in _qkv(rng, 2, H, Hkv, S, dh)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ref.flash_attention(*leaves, causal=causal, window=window)
    do = torch.from_numpy(rng.standard_normal(out.shape))
    want = torch.autograd.grad(out, leaves, do)
    q, k, v = (t.detach() for t in leaves)
    lse = ref.attention_lse(q, k, causal=causal, window=window)
    got = ref.flash_attention_bwd(q, k, v, out.detach(), do, lse,
                                  causal=causal, window=window)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


BWD_TOL = {"bfloat16": 3e-2, "float32": 1e-4}   # chip_smoke.py's


def _grad_err(got, want) -> float:
    """max|got - want| over dq, dk, dv, over the largest |want| of the
    three (chip_smoke.py's ``grad_err``)."""
    scale = max(float(w.float().abs().max()) for w in want)
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want)) / max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("window", [0, 17])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,group,dh", [(1, 1, 16), (63, 3, 24), (65, 4, 64),
                                        (192, 8, 128), (130, 2, 80),
                                        (64, 1, 200)])
def test_flash_bwd_kernel_matches_plain(cuda_device, S, group, dh, causal,
                                        window, dtype):
    """The backward kernel (from the forward kernel's output and
    log-sum-exp) against ``ref.flash_attention_bwd`` on the same inputs,
    within BWD_TOL of the largest gradient; the log-sum-exp within 1e-3
    of the plain one."""
    _, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(S * 11 + dh + group)
    q, k, v = _torch(_qkv(rng, 2, 2 * group, 2, S, dh), tdt, cuda_device)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(device=cuda_device, dtype=tdt)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal, window, with_lse=True)
    assert float((lse - ref.attention_lse(q, k, causal=causal,
                                          window=window)).abs().max()) < 1e-3
    ops.reset_launch_counts()
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal, window)
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   window=window)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert all(g.dtype == tdt for g in got)
    assert _grad_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_autograd_on_card_runs_the_kernels(cuda_device, dtype):
    """``ops.flash_attention`` on inputs that need grad goes through
    ``flash_attention_op`` and its registered autograd: the forward kernel with its log-sum-exp, then one
    backward launch whose gradients equal the direct call's bit for bit.
    Under ``no_grad`` the forward alone (no log-sum-exp)."""
    _, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(3)
    q, k, v = _torch(_qkv(rng, 2, 6, 2, 130, 64), tdt, cuda_device)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(device=cuda_device, dtype=tdt)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    o, lse = tfa.flash_attention_cuda(q, k, v, True, with_lse=True)
    want = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, True)
    assert torch.equal(out, o)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        assert not ops.flash_attention(*leaves, causal=True).requires_grad


# -- the soft cap ---------------------------------------------------------------

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

# Gemma 2's attention logit cap (arXiv:2408.00118), and a tight one that
# bends most of these logits
SOFTCAPS = (50.0, 5.0)
LOGIT_SCALE = 4.0   # q scaled so the logits reach a few tens: past 5, near 50


def _jax_attention(q, k, v, causal, window, softcap):
    """The reference's einsum attention, ``repro.models.layers.
    multihead_attention`` (rope off), on q:[B,H,S,dh], k/v:[B,Hkv,S,dh]
    -> [B,H,S,dh]: each token's input is [q | k | v], which wq, wk and wv
    pick out exactly, and wo is the identity."""
    B, H, S, dh = q.shape
    hkv = k.shape[1]
    cfg = jconfigs.get_smoke("llama3_8b").replace(
        n_heads=H, n_kv_heads=hkv, head_dim=dh, attn_logit_softcap=softcap,
        dtype="float32")
    widths = (H * dh, hkv * dh, hkv * dh)
    x = jnp.concatenate([t.transpose(0, 2, 1, 3).reshape(B, S, -1)
                         for t in (q, k, v)], axis=-1)
    eye = jnp.eye(sum(widths), dtype=jnp.float32)
    cols = np.cumsum((0,) + widths)
    params = {name: eye[:, cols[i]:cols[i + 1]]
              for i, name in enumerate(("wq", "wk", "wv"))}
    params["wo"] = jnp.eye(H * dh, dtype=jnp.float32)
    out = jlayers.multihead_attention(params, x, jnp.zeros((B, S), jnp.int32),
                                      cfg, causal=causal, use_rope=False,
                                      window=window)
    return out.reshape(B, S, H, dh).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("softcap", SOFTCAPS)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 7),
                                           (False, 9)])
@pytest.mark.parametrize("H,Hkv,S,dh", [(4, 2, 33, 16), (3, 1, 20, 24)])
def test_softcapped_plain_versions_match_jax(H, Hkv, S, dh, causal, window,
                                             softcap):
    """``ref.flash_attention``, ``ref.attention_lse`` and
    ``ref.flash_attention_bwd`` with a soft cap against the reference's
    einsum attention and ``jax.vjp`` of it, fp32, from the same inputs and
    output gradient (q scaled so the logits reach the cap): the output
    within 1e-5, the log-sum-exp within 1e-5 of the capped logits' (the
    reference's formula on its own logits), the gradients within 1e-4 of
    the largest (fp32 sums over the rows and the cap's tanh). The
    uncapped output differs by more than the tolerance."""
    rng = np.random.default_rng(S + dh + window + int(softcap))
    q, k, v = _qkv(rng, 2, H, Hkv, S, dh)
    q = q * LOGIT_SCALE
    g = rng.standard_normal(q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: _jax_attention(
        a, b, c, causal, window, softcap), *(jnp.asarray(a) for a in (q, k, v)))
    dwant = vjp(jnp.asarray(g))
    tq, tk, tv = _torch((q, k, v), torch.float32)
    out = ref.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(np.abs(ref.flash_attention(
        tq, tk, tv, causal=causal, window=window).numpy()
        - np.asarray(want)).max()) > 1e-3
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.repeat(
        jnp.asarray(k), H // Hkv, axis=1)) / np.sqrt(dh)
    logits = softcap * jnp.tanh(logits / softcap) + jlayers.\
        attention_scores_mask(S, S, window, causal)
    lse = ref.attention_lse(tq, tk, causal=causal, window=window,
                            softcap=softcap)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.nn.logsumexp(logits, axis=-1)), rtol=1e-5, atol=1e-5)
    got = ref.flash_attention_bwd(tq, tk, tv, out, torch.from_numpy(g), lse,
                                  causal=causal, window=window,
                                  softcap=softcap)
    scale = max(float(np.abs(np.asarray(d)).max()) for d in dwant)
    for a, b in zip(got, dwant):
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("softcap", SOFTCAPS)
def test_softcapped_attention_grad_on_cpu_matches_jax(softcap):
    """``ops.flash_attention`` with a cap on the CPU under autograd (the
    plain version) against ``jax.vjp`` of the reference's attention: the
    gradients within 1e-4 of the largest; no backward kernel runs."""
    rng = np.random.default_rng(int(softcap))
    q, k, v = _qkv(rng, 1, 6, 2, 40, 16)
    q = q * LOGIT_SCALE
    g = rng.standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: _jax_attention(a, b, c, True, 0, softcap),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _torch((q, k, v), torch.float32)]
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.flash_attention(*leaves, causal=True,
                                                  softcap=softcap),
                              leaves, torch.from_numpy(g))
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    scale = max(float(np.abs(np.asarray(d)).max()) for d in want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   rtol=0, atol=1e-4)


def test_softcap_must_not_be_negative():
    """A negative cap is refused before any launch (0 is none)."""
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="softcap"):
        tfa._softcap(-1.0)
    with pytest.raises(ValueError, match="softcap"):
        tfa.flash_attention_cuda(q, q, q, True, softcap=-1.0)


# -- the Hopper backward on the card ---------------------------------------------

TRAIN_SHAPE = (2, 24, 8, 4096, 128)   # Phi-4-mini-3.8B's attention, batch 2


def _bwd_inputs(rng, B, H, Hkv, S, dh, device, scale=1.0):
    q, k, v = _qkv(rng, B, H, Hkv, S, dh)
    do = rng.standard_normal(q.shape).astype(np.float32)
    return _torch((q * scale, k, v, do), torch.bfloat16, device)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("S", [65, 300])
@pytest.mark.parametrize("window", [0, 1, 17, 4096])
@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 80, 128])
def test_flash_bwd_hopper_matches_plain(cuda_device, dh, causal, group,
                                        window, S, softcap):
    """The Hopper backward (bf16 at dh 64 and 128; 80 padded to 128) from
    the forward kernel's output and log-sum-exp, against
    ``ref.flash_attention_bwd``: within BWD_TOL of the largest gradient,
    one launch; q scaled so the capped logits bend."""
    rng = np.random.default_rng(dh + 7 * group + window + S + int(softcap))
    q, k, v, do = _bwd_inputs(rng, 1, 2 * group, 2, S, dh, cuda_device, 4.0)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal, window, with_lse=True,
                                      softcap=softcap)
    ops.reset_launch_counts()
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal, window,
                                       softcap)
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   window=window, softcap=softcap)
    assert all(bool(g.isfinite().all()) for g in got)
    assert _grad_err(got, want) <= BWD_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dh,causal", [(64, False), (128, True)])
def test_flash_bwd_hopper_strided_views(cuda_device, dh, causal):
    """The model's call: q, k, v, o and dO as [B,S,H,dh] activations read
    as [B,H,S,dh] views. The tensor maps read them as they are (no copy)
    and the gradients come back in the same layouts, equal to the call on
    contiguous copies."""
    rng = np.random.default_rng(dh)
    q, k, v, do = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _bwd_inputs(rng, 2, 6, 2, 200, dh, cuda_device))
    o, lse = tfa.flash_attention_cuda(q, k, v, causal, with_lse=True)
    assert all(tfa._tma_view(t) is t for t in (q, k, v, o, do))
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)
    assert [g.stride() for g in got] == [t.stride() for t in (q, k, v)]
    assert not got[0].is_contiguous()
    want = tfa.flash_attention_bwd_cuda(
        *(t.contiguous() for t in (q, k, v, o, do)), lse, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_flash_bwd_hopper_bit_equal_at_the_training_shape(cuda_device):
    """Two calls at Phi-4-mini's training shape give the same bits (dQ is
    summed over key tiles in a fixed order), within BWD_TOL of the plain
    version."""
    B, H, Hkv, S, dh = TRAIN_SHAPE
    q, k, v, do = _bwd_inputs(np.random.default_rng(0), B, H, Hkv, S, dh,
                              cuda_device)
    o, lse = tfa.flash_attention_cuda(q, k, v, True, with_lse=True)
    a = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, True)
    b = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _grad_err(a, ref.flash_attention_bwd(q, k, v, o, do, lse,
                                                causal=True)) <= BWD_TOL[
        "bfloat16"]


@pytest.mark.cuda
def test_flash_bwd_hopper_refuses_other_cards(cuda_device, monkeypatch):
    """The Hopper backward raises on a card that is not sm_90; it never
    runs another design instead."""
    q, k, v, do = _bwd_inputs(np.random.default_rng(1), 1, 2, 2, 64, 64,
                              cuda_device)
    o, lse = tfa.flash_attention_cuda(q, k, v, True, with_lse=True)
    monkeypatch.setattr(tfa, "_card", lambda index: ((8, 0), "A100"))
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="sm_90"):
        tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, True)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [("float32", 64), ("bfloat16", 32),
                                      ("float32", 128)])
def test_flash_kernels_softcap_match_plain_on_card(cuda_device, dtype, dh):
    """The forward's mma.sync and fp32 designs and the backward's fp32 and
    mma.sync ones with a cap of 5 (unit-normal inputs: logits of a few
    units, which the cap bends by up to about a fifth, the softmax kept
    smooth)
    against the plain versions: the output within the dtype's tolerance,
    the log-sum-exp within 1e-3, the gradients within BWD_TOL."""
    _, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(dh)
    q, k, v = _torch(_qkv(rng, 1, 6, 2, 130, dh), tdt, cuda_device)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(device=cuda_device, dtype=tdt)
    o, lse = tfa.flash_attention_cuda(q, k, v, True, with_lse=True,
                                      softcap=5.0)
    np.testing.assert_allclose(_f32(o), _f32(ref.flash_attention(
        q, k, v, causal=True, softcap=5.0)), rtol=tol, atol=tol)
    assert float((lse - ref.attention_lse(q, k, causal=True,
                                          softcap=5.0)).abs().max()) < 1e-3
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, True, 0, 5.0)
    want = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                   softcap=5.0)
    assert _grad_err(got, want) <= BWD_TOL[dtype]
