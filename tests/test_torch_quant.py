"""The port's quantized kernels (quant_score, sq8_topk, pq_topk) against the
JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX kernels (Pallas in interpret
mode, and the ``ref`` / ``*_xla`` versions) and through the port's plain
versions, which is what ``repro_torch.kernels.ops`` runs for CPU tensors.
Tolerance (``repro_torch.kernels.parity``): scores within 1e-5 (fp32, the
summation order differs), ids equal outside groups of near-tied scores; on
duplicated rows or codes the ids must be exactly equal.

The ``cuda``-marked tests hold the hand-written kernels against the plain
versions; they need a card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes; the suite runs several workers at once, so one intra-op
# thread each keeps torch from crowding the timing-sensitive tests
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_retrieve as jfr  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quant_score import quant_score_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.parity import compare_topk  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _sq8(rng, n, d):
    """Codes and scale of unit rows, as the vector DB's ``_train_sq``
    makes them."""
    x = _unit(rng, n, d)
    scale = (np.abs(x).max(0) / 127.0 + 1e-12).astype(np.float32)
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return codes, scale


def _assert_parity(jax_out, torch_out):
    s_ref, i_ref = (np.asarray(a) for a in jax_out)
    got = compare_topk(s_ref, i_ref, *torch_out)
    assert got["violations"] == 0, got
    assert torch_out[1].dtype == torch.int32


def _padding_contract(s, i, n_live):
    s, i = s.numpy(), i.numpy()
    for r in range(s.shape[0]):
        valid = i[r][i[r] >= 0]
        assert len(valid) == len(set(valid.tolist()))
        dead = i[r] < 0
        assert (s[r][dead] <= ref.NEG / 2).all()
        assert (s[r][~dead] > ref.NEG / 2).all()
        assert (~dead).sum() == min(n_live, s.shape[1])


# -- quant_score ----------------------------------------------------------------


@pytest.mark.parametrize("nq,N,d", [(3, 100, 32), (16, 1100, 48), (1, 64, 8)])
def test_quant_score_matches_jax(nq, N, d):
    rng = np.random.default_rng(nq + N)
    q = _unit(rng, nq, d)
    codes, scale = _sq8(rng, N, d)
    out = ops.quant_score(*_t(q, codes, scale))
    assert out.shape == (nq, N) and out.dtype == torch.float32
    for want in (quant_score_pallas(*_j(q, codes, scale), interpret=True),
                 jref.quant_score(*_j(q, codes, scale))):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# -- sq8_topk -------------------------------------------------------------------


@pytest.mark.parametrize("nq,N,d,k,p_live", [
    (2, 77, 16, 3, 0.9),
    (4, 1030, 32, 9, 0.9),     # N just past one TPU tile
    (7, 500, 24, 16, 0.3),
])
def test_sq8_topk_matches_jax(nq, N, d, k, p_live):
    rng = np.random.default_rng(nq * 13 + N)
    q = _unit(rng, nq, d)
    codes, scale = _sq8(rng, N, d)
    live = rng.random(N) < p_live
    out = ops.sq8_topk(*_t(q, codes, scale, live), k)
    j_in = _j(q, codes, scale, live)
    _assert_parity(jfr.sq8_topk_pallas(*j_in, k, interpret=True), out)
    _assert_parity(jfr.sq8_topk_xla(*j_in, k), out)


@pytest.mark.parametrize("case", ["k_gt_tile", "k_gt_live", "n_lt_k",
                                  "all_dead_nq1"])
def test_sq8_topk_edge_cases_match_jax(case):
    """Rows with fewer than k live matches pad with (NEG, -1), as the TPU
    kernel does."""
    rng = np.random.default_rng(5)
    if case == "k_gt_tile":        # JAX bn=4 < k=8: tiles drain early
        nq, N, d, k, live, kw = 3, 32, 8, 8, np.ones(32, bool), {"bn": 4,
                                                                  "bq": 8}
    elif case == "k_gt_live":
        nq, N, d, k, kw = 2, 64, 8, 6, {}
        live = np.zeros(64, bool)
        live[[3, 17, 40]] = True
    elif case == "n_lt_k":
        nq, N, d, k, live, kw = 1, 5, 8, 8, np.ones(5, bool), {}
    else:
        nq, N, d, k, live, kw = 1, 129, 24, 4, np.zeros(129, bool), {}
    q = _unit(rng, nq, d)
    codes, scale = _sq8(rng, N, d)
    s, i = ops.sq8_topk(*_t(q, codes, scale, live), k)
    _padding_contract(s, i, int(live.sum()))
    _assert_parity(jfr.sq8_topk_pallas(*_j(q, codes, scale, live), k,
                                       interpret=True, **kw), (s, i))


def test_sq8_topk_tie_order_matches_jax():
    """Equal scores on repeated code rows keep the lower row, as the TPU
    kernel's argmax rounds do."""
    rng = np.random.default_rng(9)
    base, scale = _sq8(rng, 6, 16)
    codes = np.concatenate([base, base, base[::-1]])      # every row 3 times
    live = np.ones(len(codes), bool)
    live[4] = False
    q = _unit(rng, 3, 16)
    s, i = ops.sq8_topk(*_t(q, codes, scale, live), 7)
    js, ji = jfr.sq8_topk_pallas(*_j(q, codes, scale, live), 7,
                                 interpret=True)
    assert (i.numpy() == np.asarray(ji)).all()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    for r in range(3):   # three copies of one row score equal, lowest first
        assert s[r, 0] == s[r, 1]
        assert i[r, 0] < i[r, 1]


# -- pq_topk --------------------------------------------------------------------


def test_pq_lut_and_adc_sum_match_jax():
    """The table is the same einsum; the sum adds the subspaces in order,
    so it equals the reference's ``adc_sum`` bit for bit."""
    rng = np.random.default_rng(21)
    q = _unit(rng, 5, 32)
    codebook = rng.standard_normal((8, 256, 4)).astype(np.float32)
    lut = ref.pq_lut(*_t(q, codebook))
    assert lut.shape == (5, 8, 256)
    np.testing.assert_allclose(lut.numpy(),
                               np.asarray(jfr._pq_lut(*_j(q, codebook))),
                               rtol=0, atol=1e-6)
    gath = rng.standard_normal((7, 11, 8)).astype(np.float32)
    np.testing.assert_array_equal(ref.adc_sum(*_t(gath)).numpy(),
                                  np.asarray(jfr.adc_sum(*_j(gath))))


def _pq_packed(rng, nlist, cap_b, m, p_ok, dup=False):
    rows = nlist * cap_b
    codes = rng.integers(0, 256, (rows, m)).astype(np.int32)
    if dup:                                # equal scores inside a bucket
        codes[1::2] = codes[0::2]
    ok = (rng.random(rows) < p_ok).astype(np.int8)
    slot = np.where(ok > 0, rng.permutation(rows) + 3, -1).astype(np.int32)
    return codes, slot, ok


@pytest.mark.parametrize("nq,nlist,cap_b,d,m,nprobe,k,p_ok,dup", [
    (4, 4, 32, 16, 4, 2, 5, 0.5, False),
    (3, 4, 16, 32, 8, 4, 20, 0.4, False),   # k > cap_b and > live per bucket
    (5, 4, 24, 16, 4, 3, 6, 0.7, True),     # exact ties inside buckets
    (1, 4, 8, 16, 2, 2, 4, 0.0, False),     # every bucket dead
    (2, 8, 40, 24, 3, 3, 7, 0.8, True),     # m % 4 != 0
])
def test_pq_topk_matches_jax(nq, nlist, cap_b, d, m, nprobe, k, p_ok, dup):
    rng = np.random.default_rng(nq * 31 + cap_b)
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    codebook = (0.3 * rng.standard_normal((m, 256, d // m))).astype(
        np.float32)
    codes, slot, ok = _pq_packed(rng, nlist, cap_b, m, p_ok, dup)
    inputs = (q, codebook, cent, codes, slot, ok)
    out = ops.pq_topk(*_t(*inputs), nprobe, k)
    assert out[0].shape == out[1].shape == (nq, k)
    jp = jfr.pq_topk_pallas(*_j(*inputs), nprobe, k, interpret=True)
    _assert_parity(jp, out)
    _assert_parity(jfr.pq_topk_xla(*_j(*inputs), nprobe, k), out)
    if dup:   # exact tie order against the TPU kernel's argmax rounds
        assert (out[1].numpy() == np.asarray(jp[1])).all()
    if p_ok == 0.0:
        assert (out[1] == -1).all() and (out[0] <= ref.NEG / 2).all()


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nq,N,d", [(3, 100, 32), (70, 3000, 48), (1, 5, 8),
                                    (65, 1025, 24)])
def test_quant_score_kernel_matches_plain(cuda_device, nq, N, d):
    rng = np.random.default_rng(N)
    q = _unit(rng, nq, d)
    args = [a.to(cuda_device) for a in _t(q, *_sq8(rng, N, d))]
    diff = (ops.quant_score(*args) - ref.quant_score(*args)).abs().max()
    assert float(diff) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nq,N,d,k,p_live", [
    (3, 32, 8, 8, 1.0), (2, 64, 8, 6, 0.05), (1, 5, 8, 8, 1.0),
    (1, 129, 24, 4, 0.0), (70, 3000, 32, 128, 0.9), (5, 4101, 48, 16, 0.8)])
def test_sq8_topk_kernel_matches_plain(cuda_device, nq, N, d, k, p_live):
    rng = np.random.default_rng(N)
    q = _unit(rng, nq, d)
    codes, scale = _sq8(rng, N, d)
    live = rng.random(N) < p_live
    args = [a.to(cuda_device) for a in _t(q, codes, scale, live)]
    got = compare_topk(*ref.sq8_topk(*args, k), *ops.sq8_topk(*args, k))
    assert got["violations"] == 0, got


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nlist,cap_b,d,m,nprobe,k,p_ok,dup", [
    (4, 4, 32, 16, 4, 2, 5, 0.5, False), (3, 4, 16, 32, 8, 4, 20, 0.4, False),
    (5, 4, 24, 16, 4, 3, 6, 0.7, True), (1, 4, 8, 16, 2, 2, 4, 0.0, False),
    (9, 16, 256, 48, 48, 5, 128, 0.5, True)])
def test_pq_topk_kernel_matches_plain(cuda_device, nq, nlist, cap_b, d, m,
                                      nprobe, k, p_ok, dup):
    """The kernel adds the subspaces in the plain version's order, so ids
    and scores are equal, not just close."""
    rng = np.random.default_rng(cap_b)
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    codebook = (0.3 * rng.standard_normal((m, 256, d // m))).astype(
        np.float32)
    args = [a.to(cuda_device) for a in _t(
        q, codebook, cent, *_pq_packed(rng, nlist, cap_b, m, p_ok, dup))]
    want = ref.pq_topk(*args, nprobe, k)
    got = ops.pq_topk(*args, nprobe, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _grid(rng, n, d):
    """Entries in {-0.5, -0.25, 0, 0.25, 0.5}: with small integer codes and
    a scale of 1, every dot product is exact in fp32 whatever the summation
    order, so ties are real ties."""
    return (rng.integers(-2, 3, (n, d)) / 4).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 128])
def test_sq8_topk_kernel_tie_order(cuda_device, k):
    """Every code row three times, the copies in other sub-tiles and corpus
    tiles, on exact scores: ids and scores equal the plain version's."""
    rng = np.random.default_rng(k)
    base = rng.integers(-3, 4, (1000, 32)).astype(np.int8)
    codes = np.concatenate([base, base, base[::-1]])
    live = rng.random(len(codes)) < 0.9
    scale = np.full(32, 0.5, np.float32)
    args = [a.to(cuda_device) for a in _t(_grid(rng, 6, 32), codes, scale,
                                          live)]
    want, got = ref.sq8_topk(*args, k), ops.sq8_topk(*args, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    exact = ref.quant_score(*args[:3])
    assert torch.equal(ops.quant_score(*args[:3]), exact)
