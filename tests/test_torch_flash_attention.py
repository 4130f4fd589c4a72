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
