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
from repro_torch.kernels import fused_retrieve as tfr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.parity import compare_topk  # noqa: E402
from repro.core.interfaces import Chunk as JChunk  # noqa: E402
from repro.core.vectordb import DBConfig as JDBConfig  # noqa: E402
from repro.core.vectordb import JaxVectorDB  # noqa: E402
from repro_torch import convert  # noqa: E402

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


def _grid(rng, n, d):
    """Entries in {-0.5, -0.25, 0, 0.25, 0.5}: with small integer codes and
    a scale of 1, every dot product is exact in fp32 whatever the summation
    order, so ties are real ties."""
    return (rng.integers(-2, 3, (n, d)) / 4).astype(np.float32)


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


# -- sq8_topk's limb route (the card kernel's arithmetic) -----------------------


def _split_bound(qs, codes, limbs_e):
    """Per (query, row): sum_j |c_j| 2^(e - 7 L), the limb split's error
    bound."""
    limbs, e = limbs_e
    step = 2.0 ** (e.double() - 7 * limbs.shape[0])
    return step[:, None] * codes.double().abs().sum(1)[None, :]


@pytest.mark.parametrize("d", [8, 24, 384])
def test_sq8_limbs_rebuild_qs(d):
    """The limbs are int8 in [-64, 64], 2^e is the least power of two at
    or above the row's max |q * scale|, and sum_l 2^(e - 6 - 7 l) limb_l
    rebuilds q * scale within 2^(e - 7L) per element."""
    rng = np.random.default_rng(d)
    q = _unit(rng, 9, d)
    q[3] = 0.0                                   # a zero row: all limbs 0
    _, scale = _sq8(rng, 50, d)
    qs = torch.from_numpy(q * scale[None, :])
    limbs, e = tfr.sq8_limbs(qs)
    assert limbs.dtype == torch.int8 and limbs.shape == (4, 9, d)
    assert e.dtype == torch.int32 and e.shape == (9,)
    assert int(limbs.abs().max()) <= 64 and not limbs[:, 3].any()
    assert int(e[3]) == -96                      # the floor
    amax = qs.abs().amax(1).double()
    top = 2.0 ** e.double()
    live = amax > 0
    assert ((amax <= top) & (amax > top / 2))[live].all()
    w = 2.0 ** (e.double()[None, :] - 6 - 7 * torch.arange(4.0)[:, None])
    rebuilt = (limbs.double() * w[:, :, None]).sum(0)
    err = (rebuilt - qs.double()).abs()
    assert (err <= 2.0 ** (e.double() - 28)[:, None]).all()


@pytest.mark.parametrize("d", [8, 24, 384])
def test_sq8_limb_scores_match_quant_score(d):
    """The limb route's scores are the exact product within the split's
    bound (plus fp32 rounding of the score), and the plain and JAX
    quant_score within the parity tolerance."""
    rng = np.random.default_rng(100 + d)
    q = _unit(rng, 6, d)
    codes, scale = _sq8(rng, 300, d)
    tq, tc, ts = _t(q, codes, scale)
    qs = tq * ts[None, :]
    lw = tfr.sq8_limbs(qs)
    got = tfr.sq8_limb_scores(*lw, tc)
    assert got.dtype == torch.float32 and got.shape == (6, 300)
    exact = qs.double() @ tc.double().T
    slack = exact.abs() * 2.0 ** -22 + 1e-30     # rounding of 3 fp32 adds
    assert ((got.double() - exact).abs()
            <= _split_bound(qs, tc, lw) + slack).all()
    assert float(_split_bound(qs, tc, lw).max()) <= 2.9e-6
    np.testing.assert_allclose(got.numpy(), ref.quant_score(tq, tc, ts),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.quant_score(*_j(q, codes, scale))),
        rtol=0, atol=1e-5)


def test_sq8_limb_scores_exact_on_tie_inputs():
    """Queries by 0.25 and a scale of 0.5 give q * scale by 1/8: the split
    is exact and every score equals the fp32 product's bit for bit (the
    tie inputs of the card checks)."""
    rng = np.random.default_rng(41)
    codes = rng.integers(-3, 4, (500, 32)).astype(np.int8)
    q = _grid(rng, 7, 32)
    scale = np.full(32, 0.5, np.float32)
    tq, tc, ts = _t(q, codes, scale)
    got = tfr.sq8_limb_scores(*tfr.sq8_limbs(tq * ts[None, :]), tc)
    assert torch.equal(got, ref.quant_score(tq, tc, ts))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.quant_score(*_j(q, codes, scale))))


@pytest.mark.parametrize("nq,N,d,k,p_live", [
    (2, 77, 16, 3, 0.9),
    (4, 1030, 24, 9, 0.9),
    (7, 500, 384, 16, 0.3),
])
def test_sq8_limb_topk_matches_jax(nq, N, d, k, p_live):
    """The top-k of the limb route's scores (the card kernel's result)
    against the TPU kernel in interpret mode, under the parity rule."""
    rng = np.random.default_rng(nq * 7 + N)
    q = _unit(rng, nq, d)
    codes, scale = _sq8(rng, N, d)
    live = rng.random(N) < p_live
    tq, tc, ts, tl = _t(q, codes, scale, live)
    scores = tfr.sq8_limb_scores(*tfr.sq8_limbs(tq * ts[None, :]), tc)
    got = ref.masked_topk(scores, tl, k)
    _assert_parity(jfr.sq8_topk_pallas(*_j(q, codes, scale, live), k,
                                       interpret=True), got)
    _padding_contract(*got, int(live.sum()))



@pytest.mark.parametrize("d", [768, 1024])
def test_sq8_limb_scores_wide_match_pallas(d):
    """At the widths the card streams the limbs (Fig. 11's 768 and 1,024):
    the limb route's scores within 1e-5 of the TPU kernel in interpret
    mode, and within the split's bound, 127 d 2^-34 for unit rows (7.6e-6
    at 1,024), of the exact product."""
    rng = np.random.default_rng(200 + d)
    q = _unit(rng, 5, d)
    codes, scale = _sq8(rng, 260, d)
    tq, tc, ts = _t(q, codes, scale)
    qs = tq * ts[None, :]
    lw = tfr.sq8_limbs(qs)
    got = tfr.sq8_limb_scores(*lw, tc)
    exact = qs.double() @ tc.double().T
    slack = exact.abs() * 2.0 ** -22 + 1e-30     # rounding of 3 fp32 adds
    assert ((got.double() - exact).abs()
            <= _split_bound(qs, tc, lw) + slack).all()
    assert float(_split_bound(qs, tc, lw).max()) <= 127 * d * 2.0 ** -34
    want = quant_score_pallas(*_j(q, codes, scale), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


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


@pytest.mark.parametrize("nq,nlist,cap_b,d,m,nprobe,k,p_ok,dup", [
    (4, 4, 32, 16, 4, 2, 5, 0.5, False),
    (5, 4, 24, 16, 4, 3, 6, 0.7, True),
    (9, 16, 64, 48, 48, 5, 32, 0.5, True),
])
def test_pq_topk_uint8_codes_match_jax(nq, nlist, cap_b, d, m, nprobe, k,
                                       p_ok, dup):
    """The plain version reads the uint8 mirror as it reads int32 codes:
    the same result, and the JAX kernel's on the int32 codes."""
    rng = np.random.default_rng(nq * 17 + cap_b)
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    codebook = (0.3 * rng.standard_normal((m, 256, d // m))).astype(
        np.float32)
    codes, slot, ok = _pq_packed(rng, nlist, cap_b, m, p_ok, dup)
    got = ops.pq_topk(*_t(q, codebook, cent, codes.astype(np.uint8), slot,
                          ok), nprobe, k)
    want = ops.pq_topk(*_t(q, codebook, cent, codes, slot, ok), nprobe, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jp = jfr.pq_topk_pallas(*_j(q, codebook, cent, codes, slot, ok), nprobe,
                            k, interpret=True)
    _assert_parity(jp, got)
    if dup:
        assert (got[1].numpy() == np.asarray(jp[1])).all()


def _key_merge(s, i, order, k):
    """The pq_topk entry point's second pass (csrc/merge_lists.cuh) in
    torch: the top k of candidates [nq, C] by one 64-bit key, the score's
    order-preserving bits above the complement of ``order``."""
    bits = (s + 0.0).view(torch.int32)
    key = ((bits ^ ((bits >> 31) & 0x7FFFFFFF)).long() << 32) | (
        0x7FFFFFFF - order.long())
    pos = torch.topk(key, k, dim=1).indices
    top = torch.gather(s, 1, pos)
    return top, torch.where(top <= ref.NEG / 2, -1, torch.gather(i, 1, pos))


def _group_lists(q, codebook, cent, codes, slot, ok, nprobe, k, group):
    """The pq_topk kernel's lists in plain torch: per (query, group of
    ``group`` probes) the top-k of the group's buckets' ok rows by score,
    then pos = probe rank * cap_b + row. Returns ``[nq, groups, k]``
    scores, slot ids and pos, (NEG, -1, -1) padded."""
    nq, m, nlist = q.shape[0], codebook.shape[0], cent.shape[0]
    cap_b = codes.shape[0] // nlist
    lut = ref.pq_lut(q, codebook).reshape(nq, m * 256)
    probes = ref.probe(q, cent, nprobe).long()
    pc = codes.view(nlist, cap_b, m).long() + torch.arange(m) * 256
    ps, po = slot.view(nlist, cap_b), ok.view(nlist, cap_b).bool()
    out = []
    for p0 in range(0, nprobe, group):
        b = probes[:, p0:p0 + group]                     # [nq, g]
        s = ref.adc_sum(torch.gather(lut, 1, pc[b].reshape(nq, -1)).view(
            nq, -1, m))                                  # pos order
        s = torch.where(po[b].reshape(nq, -1), s, torch.tensor(ref.NEG))
        top, at = ref.stable_topk(s, k)
        real = top > ref.NEG / 2
        at = at.clamp(max=s.shape[1] - 1)
        sl = torch.gather(ps[b].reshape(nq, -1), 1, at)
        out.append((top, torch.where(real, sl, -1),
                    torch.where(real, p0 * cap_b + at, -1).int()))
    return [torch.stack(x, 1) for x in zip(*out)]


@pytest.mark.parametrize("group", [1, 4, 6])
def test_pq_group_lists_merge_matches_jax(group):
    """Per-group lists merged by one top-k over the (score, probe rank,
    row) key give the JAX kernel's result, ids exactly, on exact scores
    with ties planted across the probes of each query (equal code rows in
    two buckets it probes, one pair inside a group of 4 and one across
    groups), at group sizes 1, 4 and nprobe."""
    rng = np.random.default_rng(77)
    nq, nlist, cap_b, d, m, nprobe, k = 4, 8, 16, 16, 4, 6, 96   # every row
    q = _grid(rng, nq, d)                        # exact tables and sums
    cent = _unit(rng, nlist, d)
    codebook = _grid(rng, m * 256, d // m).reshape(m, 256, d // m)
    codes, slot, ok = _pq_packed(rng, nlist, cap_b, m, 0.8)
    ok[:] = 1
    slot = rng.permutation(nlist * cap_b).astype(np.int32)
    probes = ref.probe(*_t(q, cent), nprobe).numpy()
    for i in range(nq):
        for a, b in ((1, 3), (2, 5)):            # ranks inside, across 4
            src, dst = probes[i, a] * cap_b + i, probes[i, b] * cap_b + 8 + i
            codes[dst] = codes[src]              # no plant's source moves
    tin = _t(q, codebook, cent, codes, slot, ok)
    s, i_, p = _group_lists(*tin, nprobe, k, group)
    assert s.shape == (nq, -(-nprobe // group), k)
    got = _key_merge(s.view(nq, -1), i_.view(nq, -1), p.view(nq, -1), k)
    jp = jfr.pq_topk_pallas(*_j(q, codebook, cent, codes, slot, ok), nprobe,
                            k, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jp[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jp[0]))
    assert torch.equal(got[1], ops.pq_topk(*tin, nprobe, k)[1])
    # the planted pairs tie, and the lower probe rank comes first
    for i in range(nq):
        row = got[1][i].tolist()
        for a, b in ((1, 3), (2, 5)):
            lo = row.index(slot[probes[i, a] * cap_b + i])
            hi = row.index(slot[probes[i, b] * cap_b + 8 + i])
            assert lo < hi and got[0][i, lo] == got[0][i, hi]


@pytest.mark.parametrize("codes_dtype", ["int32", "uint8"])
def test_pq_codes_narrow_to_uint8(codes_dtype):
    """The card's wrapper narrows the reference's int32 codes to uint8
    (``narrow_codes``, device-agnostic): the plain version gives the same
    ids and scores on both, equal to the JAX kernel's; a code outside
    [0, 256) raises."""
    rng = np.random.default_rng(31)
    nq, nlist, cap_b, d, m, nprobe, k = 4, 8, 32, 32, 8, 3, 9
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    codebook = (0.3 * rng.standard_normal((m, 256, d // m))).astype(
        np.float32)
    codes, slot, ok = _pq_packed(rng, nlist, cap_b, m, 0.7)
    codes[0, 0], codes[1, 1] = 0, 255              # both ends of the range
    tin = _t(q, codebook, cent, codes, slot, ok)
    narrow = tfr.narrow_codes(tin[3])
    assert narrow.dtype == torch.uint8
    assert torch.equal(narrow.to(torch.int32), tin[3])
    if codes_dtype == "uint8":
        tin[3] = narrow
    got = ops.pq_topk(*tin, nprobe, k)
    want = ops.pq_topk(*tin[:3], torch.from_numpy(codes), *tin[4:], nprobe, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _assert_parity(jfr.pq_topk_pallas(*_j(q, codebook, cent, codes, slot,
                                          ok), nprobe, k, interpret=True), got)
    for bad in (-1, 256):
        wrong = tin[3].to(torch.int32).clone()
        wrong[5, 2] = bad
        with pytest.raises(ValueError, match=r"\[0, 256\)"):
            tfr.narrow_codes(wrong)


@pytest.mark.parametrize("k", [1, 7, 16])
def test_op_rung_selects_by_key_like_off(k):
    """The flat + SQ8 DB's ``op`` rung (``quant_score``, then one
    ``torch.topk`` over (score, row) keys) equals the ``off`` rung (the
    plain stable sort) on one DB state, ids and scores, with rows repeated
    so that equal scores tie, tombstones and fresh rows included."""
    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB
    from repro_torch.kernels import topk_search as tts

    rng = np.random.default_rng(50 + k)
    base = _unit(rng, 150, 32)
    rows = np.concatenate([base, base[::-1], base[:60]])
    db = TorchVectorDB(DBConfig(index_type="flat", quant="sq8", dim=32,
                                capacity=512, flat_capacity=128,
                                use_kernel="op"), device="cpu")
    db.insert(rows, [Chunk(-1, i // 3, "") for i in range(len(rows))])
    db.build_index()
    db.insert(base[:40], [Chunk(-1, 200 + i, "") for i in range(40)])
    for doc in (3, 17, 40):
        db.remove(doc)
    q = torch.from_numpy(np.concatenate([base[:5], _unit(rng, 4, 32)]))
    off = db.search_arrays(q, k, rung="off")
    op = db.search_arrays(q, k, rung="op")
    assert torch.equal(op[0], off[0]) and torch.equal(op[1], off[1])
    assert (op[1] >= 0).all()
    # the key selection alone, on a score matrix full of ties
    s = torch.from_numpy(rng.integers(-2, 3, (6, 500)).astype(np.float32))
    s[:, :3] = -0.0
    live = torch.from_numpy(rng.random(500) < 0.7)
    for kk in (k, 499, 600):
        a, b = ref.masked_topk(s, live, kk), tts.select_by_row(s, live, kk)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- on the card ----------------------------------------------------------------


@pytest.mark.parametrize("index_type,quant", [("flat", "sq8"),
                                              ("ivf", "pq")])
@pytest.mark.parametrize("d", [3, 130])
@pytest.mark.parametrize("k", [200, 300])
def test_quantized_db_at_any_width_and_large_k_matches_jax(index_type, quant,
                                                           d, k):
    """The quantized DBs at a row width off the kernels' 16-byte unit and k
    above their lists' 128, on the fused rung, held to the JAX DB on the
    same state: the SQ8 codes padded with zero columns and scale 0 there
    (the PQ tables keep the true width), results equal by the parity rule,
    ``(NEG, -1)`` past the live candidates."""
    rng = np.random.default_rng(d * 3 + k)
    n = 240
    jdb = JaxVectorDB(JDBConfig(index_type=index_type, quant=quant, dim=d,
                                capacity=n + 64, nlist=4, nprobe=2,
                                flat_capacity=48, pq_m=1 if d % 2 else 2,
                                use_kernel="fused"))
    jdb.insert(_unit(rng, n, d), [JChunk(chunk_id=-1, doc_id=i // 4,
                                         text=f"c{i}") for i in range(n)])
    jdb.build_index()
    tdb = convert.db_from_jax(jdb, device="cpu")
    w = ref.padded_width(d)
    if quant == "sq8":
        assert tdb.sq_codes.shape[1] == tdb.sq_scale.shape[0] == w
        assert (tdb.sq_codes[:, d:] == 0).all()
        assert (tdb.sq_scale[d:] == 0).all()
    q = _unit(rng, 6, d)
    js, ji = jdb._search_arrays(jnp.asarray(q), k)
    ts, ti = tdb.search_arrays(torch.from_numpy(q), k)
    got = compare_topk(np.asarray(js), np.asarray(ji), ts, ti)
    assert got["violations"] == 0, got
    off = tdb.search_arrays(torch.from_numpy(q), k, rung="off")
    assert compare_topk(*off, ts, ti)["violations"] == 0


@pytest.mark.parametrize("index_type,quant", [("ivf", "none"),
                                              ("flat", "sq8"), ("ivf", "pq")])
def test_db_builds_its_own_index_at_any_width(index_type, quant):
    """A DB at d = 130 that trains its own index (k-means, SQ8 scale and
    codes, PQ codebooks) on its padded rows: zero columns in the rows and
    centroids, SQ8 codes and scale 0 in the pad, and the fused rung equal
    to the plain one at k = 150, before and after fresh inserts."""
    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB

    rng = np.random.default_rng(130)
    d = 130
    db = TorchVectorDB(DBConfig(index_type=index_type, quant=quant, dim=d,
                                capacity=400, nlist=4, nprobe=3, pq_m=2,
                                flat_capacity=64, use_kernel="fused"),
                       device="cpu")
    db.insert(_unit(rng, 300, d), [Chunk(-1, i // 4, "") for i in range(300)])
    db.build_index()
    assert db.width == 132 and (db.vectors[:, d:] == 0).all()
    if index_type == "ivf":
        assert db.centroids.shape[1] == 132
        assert (db.centroids[:, d:] == 0).all()
    if quant == "sq8":
        assert (db.sq_codes[:, d:] == 0).all() and (db.sq_scale[d:] == 0).all()
    q = torch.from_numpy(_unit(rng, 7, d))
    for _ in range(2):
        got = compare_topk(*db.search_arrays(q, 150, rung="off"),
                           *db.search_arrays(q, 150))
        assert got["violations"] == 0, got
        db.insert(_unit(rng, 20, d), [Chunk(-1, 500, "") for _ in range(20)])


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
    (9, 16, 256, 48, 48, 5, 128, 0.5, True),
    (6, 8, 96, 64, 32, 6, 16, 0.6, True),      # 16-byte code words: 2 a row
    (6, 8, 100, 64, 64, 6, 16, 0.6, False)])   # 4 a row; byte-wise ok scan
def test_pq_topk_kernel_matches_plain(cuda_device, nq, nlist, cap_b, d, m,
                                      nprobe, k, p_ok, dup):
    """The kernel adds the subspaces in the plain version's order, so ids
    and scores are equal, not just close."""
    rng = np.random.default_rng(cap_b)
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    codebook = (0.3 * rng.standard_normal((m, 256, d // m))).astype(
        np.float32)
    codes, slot, ok = _pq_packed(rng, nlist, cap_b, m, p_ok, dup)
    args = [a.to(cuda_device) for a in _t(
        q, codebook, cent, codes.astype(np.uint8), slot, ok)]
    want = ref.pq_topk(*args, nprobe, k)
    got = ops.pq_topk(*args, nprobe, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def _sq8_lists(cuda_device, q, codes, scale, live, k):
    """sq8_topk's C entry point on the card: the [nq, G, k] per-block lists
    and G."""
    from repro_torch.kernels import _build

    nq, d = q.shape
    n = codes.shape[0]
    g = min(-(-n // _build.tile_rows("sq8_topk")),
            torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    limbs, e = tfr.sq8_limbs(q * scale[None, :])
    out_s = torch.empty((nq, g, k), device=cuda_device)
    out_i = torch.empty((nq, g, k), dtype=torch.int32, device=cuda_device)
    top_s = torch.empty((nq, k), device=cuda_device)
    top_i = torch.empty((nq, k), dtype=torch.int32, device=cuda_device)
    lib, fn = _build.entry("sq8_topk", 8, 5, "s8")
    _build.check(lib, "sq8_topk", fn(
        limbs.data_ptr(), e.data_ptr(), codes.data_ptr(),
        live.view(torch.uint8).data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        top_s.data_ptr(), top_i.data_ptr(), nq, n, d, k, g,
        torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    return out_s, out_i, g


@pytest.mark.cuda
# cp.async, TMA, TMA with the limbs resident; TMA with the limbs streamed
@pytest.mark.parametrize("d", [24, 48, 384, 768, 1024])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_sq8_topk_entry_point_equals_limb_model(cuda_device, d, k):
    """Each of the entry point's lists (block b: tiles b, b + G, ...) is the
    limb model's top-k over its rows bit for bit, at 70 queries (two query
    blocks) and over 2-3 tiles a list; the wrapper's result (the entry
    point's merge) is the model's top-k over all rows."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(d * 1000 + k)
    n = 20000
    q = _unit(rng, 70, d)
    codes, scale = _sq8(rng, n, d)
    live = rng.random(n) < 0.9
    q, codes, scale, live = (a.to(cuda_device)
                             for a in _t(q, codes, scale, live))
    out_s, out_i, g = _sq8_lists(cuda_device, q, codes, scale, live, k)
    model = tfr.sq8_limb_scores(*tfr.sq8_limbs(q * scale[None, :]), codes)
    block = (torch.arange(n, device=cuda_device)
             // _build.tile_rows("sq8_topk")) % g
    for b in range(g):
        want = ref.masked_topk(model, live & (block == b), k)
        assert torch.equal(out_s[:, b], want[0]), b
        assert torch.equal(out_i[:, b], want[1]), b
    got = ops.sq8_topk(q, codes, scale, live, k)
    want = ref.masked_topk(model, live, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    par = compare_topk(*ref.sq8_topk(q, codes, scale, live, k), *got)
    assert par["violations"] == 0, par


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(256, 16), (512, 16), (512, 67), (516, 16),
                                 (768, 1), (768, 16), (768, 128), (1024, 1),
                                 (1024, 16), (1024, 128), (2052, 16),
                                 (4096, 128)])
def test_sq8_topk_kernel_wide_rows_equal_limb_model(cuda_device, d, k):
    """Rows of two chunks (resident limbs) and of four and more (the limbs
    streamed with the codes; 516 and 2052 by cp.async, the others by TMA;
    past 512 the converter, past 2,064 rounding as the model rounds): the
    limb model's top-k bit for bit at every width."""
    rng = np.random.default_rng(d + k)
    q = _unit(rng, 10, d)
    codes, scale = _sq8(rng, 5000, d)
    live = rng.random(5000) < 0.9
    args = [a.to(cuda_device) for a in _t(q, codes, scale, live)]
    got = ops.sq8_topk(*args, k)
    q, codes, scale, live = args
    want = ref.masked_topk(tfr.sq8_limb_scores(
        *tfr.sq8_limbs(q * scale[None, :]), codes), live, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [24, 48, 384, 512, 516, 768, 1024, 2052])
@pytest.mark.parametrize("nq,n", [(70, 3001), (64, 4096), (1, 5)])
def test_quant_score_kernel_equals_limb_model(cuda_device, d, nq, n):
    """Every score bit for bit the limb model's, on both load paths (24,
    516 and 2052 by cp.async), with the limbs resident (d <= 384) and
    streamed (512: the integer-add conversion), across two query blocks, a ragged last tile and an odd N (the
    scalar stores), and within 1e-5 of the plain version."""
    rng = np.random.default_rng(d * 7 + n)
    q = _unit(rng, nq, d)
    args = [a.to(cuda_device) for a in _t(q, *_sq8(rng, n, d))]
    got = ops.quant_score(*args)
    q, codes, scale = args
    want = tfr.sq8_limb_scores(*tfr.sq8_limbs(q * scale[None, :]), codes)
    assert got.shape == (nq, n) and torch.equal(got, want)
    assert float((got - ref.quant_score(*args)).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 128])
def test_sq8_topk_kernel_ties_across_a_blocks_tiles(cuda_device, k):
    """Each query's best row planted in three tiles that one block folds
    into one list, on exact scores: ids and scores equal the plain
    version's, the planted rows lead in row order."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(300 + k)
    tile = _build.tile_rows("sq8_topk")
    g = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n, nq, b = 3 * g * tile + 77, tile, g // 2   # one planted row a query
    codes = rng.integers(-3, 4, (n, 32)).astype(np.int8)
    q = _grid(rng, nq, 32)
    live = rng.random(n) < 0.9
    j = np.arange(nq)
    planted = np.stack([b * tile + j, (b + g) * tile + tile - 1 - j,
                        (b + 2 * g) * tile + (j + 10) % tile], 1)
    for col in range(3):
        codes[planted[:, col]] = 3 * np.sign(q).astype(np.int8)
    live[planted] = True
    scale = np.full(32, 0.5, np.float32)
    args = [a.to(cuda_device) for a in _t(q, codes, scale, live)]
    want, got = ref.sq8_topk(*args, k), ops.sq8_topk(*args, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lead = torch.from_numpy(planted[:, :min(k, 3)]).int().to(cuda_device)
    assert torch.equal(got[1][:, :min(k, 3)], lead)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_sq8_topk_kernel_wide_ties_across_a_blocks_tiles(cuda_device, d, k):
    """The tie check across the tiles one block folds, with the limbs
    streamed: each query's best row planted in three such tiles on exact
    scores; ids and scores equal the plain version's."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(400 + d + k)
    tile = _build.tile_rows("sq8_topk")
    g = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n, nq, b = 3 * g * tile + 77, 70, g // 2
    codes = rng.integers(-3, 4, (n, d)).astype(np.int8)
    q = _grid(rng, nq, d)
    live = rng.random(n) < 0.9
    j = np.arange(nq)
    planted = np.stack([b * tile + j % tile,
                        (b + g) * tile + tile - 1 - j % tile,
                        (b + 2 * g) * tile + (j + 10) % tile], 1)
    for col in range(3):
        codes[planted[:, col]] = 3 * np.sign(q).astype(np.int8)
    live[planted] = True
    scale = np.full(d, 0.5, np.float32)
    args = [a.to(cuda_device) for a in _t(q, codes, scale, live)]
    want, got = ref.sq8_topk(*args, k), ops.sq8_topk(*args, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_pq_topk_kernel_takes_uint8_codes(cuda_device):
    """On the card the mirror's uint8 codes are read as they are, and the
    reference's int32 codes are narrowed to them: the same ids and scores;
    an int32 code outside [0, 256) raises."""
    rng = np.random.default_rng(8)
    q, cent = _unit(rng, 3, 16), _unit(rng, 4, 16)
    codebook = (0.3 * rng.standard_normal((4, 256, 4))).astype(np.float32)
    codes, slot, ok = _pq_packed(rng, 4, 32, 4, 0.5)
    args = [a.to(cuda_device) for a in _t(q, codebook, cent, codes, slot, ok)]
    from_int32 = ops.pq_topk(*args, 2, 5)
    bad = args[3].clone()
    bad[7, 1] = 256
    with pytest.raises(ValueError, match="packed_codes"):
        ops.pq_topk(*args[:3], bad, *args[4:], 2, 5)
    args[3] = args[3].to(torch.uint8)
    got, want = ops.pq_topk(*args, 2, 5), ref.pq_topk(*args, 2, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(from_int32[0], got[0])
    assert torch.equal(from_int32[1], got[1])


@pytest.mark.cuda
def test_db_pq_packed_mirror_is_uint8_on_card(cuda_device):
    """The PQ DB's packed mirror on the card is uint8, gathered from the
    int32 codes, and its fused rung equals the plain rung."""
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB
    from repro_torch.core.interfaces import Chunk

    rng = np.random.default_rng(12)
    db = TorchVectorDB(DBConfig(dim=32, quant="pq", pq_m=8, capacity=600,
                                nlist=8, nprobe=6, flat_capacity=64,
                                use_kernel="fused"), device="cuda")
    db.insert(_unit(rng, 500, 32), [Chunk(-1, i // 4, "") for i in range(500)])
    db.build_index()
    codes = db.packed["codes"]
    assert codes.dtype == torch.uint8 and codes.is_cuda
    assert db.pq_codes.dtype == torch.int32
    assert torch.equal(codes, db.pq_codes[
        db.packed["slot"].clamp(min=0).long()].to(torch.uint8))
    q = torch.from_numpy(_unit(rng, 9, 32)).to(cuda_device)
    par = compare_topk(*db.search_arrays(q, 7, rung="off"),
                       *db.search_arrays(q, 7))
    assert par["violations"] == 0, par


# the card's limits lifted: row widths off the 16-byte unit (zero-padded,
# scale 0 in the pad), k above the lists' 128, a PQ table larger than
# shared memory
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 130, 383])
def test_quant_score_kernel_any_width(cuda_device, d):
    rng = np.random.default_rng(d)
    q = _unit(rng, 7, d)
    args = [a.to(cuda_device) for a in _t(q, *_sq8(rng, 1500, d))]
    ops.reset_launch_counts()
    got = ops.quant_score(*args)
    assert ops.launch_counts()["quant_score"] == 1 and got.shape == (7, 1500)
    assert float((got - ref.quant_score(*args)).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 130, 383])
@pytest.mark.parametrize("k", [16, 129, 500, 1024])
def test_sq8_topk_kernel_any_width_and_k(cuda_device, d, k):
    rng = np.random.default_rng(d * 5 + k)
    q = _unit(rng, 9, d)
    codes, scale = _sq8(rng, 3000, d)
    for p_live in (0.9, 0.1):
        live = rng.random(3000) < p_live
        args = [a.to(cuda_device) for a in _t(q, codes, scale, live)]
        ops.reset_launch_counts()
        got = ops.sq8_topk(*args, k)
        assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                       "sq8_topk": 1}
        want = ref.sq8_topk(*args, k)
        assert compare_topk(*want, *got)["violations"] == 0
        _padding_contract(got[0].cpu(), got[1].cpu(), int(live.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,k", [(256, 512, 16), (256, 512, 500),
                                   (48, 384, 129), (8, 32, 1024)])
def test_pq_topk_kernel_large_table_and_k(cuda_device, m, d, k):
    """m = 256 (a 256 KB table, past shared memory) and k above 128: the
    table read from global memory, the subspaces added in the plain
    version's order, so ids and scores are equal."""
    rng = np.random.default_rng(m + k)
    nq, nlist, cap_b = 5, 8, 160
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    codebook = (0.3 * rng.standard_normal((m, 256, d // m))).astype(
        np.float32)
    codes, slot, ok = _pq_packed(rng, nlist, cap_b, m, 0.6, dup=True)
    args = [a.to(cuda_device) for a in _t(
        q, codebook, cent, codes.astype(np.uint8), slot, ok)]
    ops.reset_launch_counts()
    got = ops.pq_topk(*args, 4, k)
    assert ops.launch_counts()["pq_topk"] == 1
    want = ref.pq_topk(*args, 4, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
