"""The port's kernel layer against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX kernels (Pallas in interpret
mode, and the ``ref`` / ``*_xla`` versions) and through the port's plain
versions, which is what ``repro_torch.kernels.ops`` runs for CPU tensors.
Tolerance (``repro_torch.kernels.parity``): scores within 1e-5 (fp32, the
summation order differs), ids equal outside groups of near-tied scores.
TF32 is off for every fp32 product (it matters only on a card).

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
from repro.kernels.topk_search import topk_search_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import fused_retrieve as tfr  # noqa: E402
from repro_torch.kernels import quant_score as tqs  # noqa: E402
from repro_torch.kernels import topk_search as tts  # noqa: E402
from repro_torch.kernels.parity import compare_topk  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


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


# -- topk_search ------------------------------------------------------------


@pytest.mark.parametrize("nq,N,d,k,p_live", [
    (1, 64, 16, 1, 0.8),
    (7, 500, 32, 5, 0.8),
    (5, 130, 24, 8, 0.85),     # N not a multiple of the TPU tile
    (3, 512, 16, 16, 0.3),
])
def test_topk_search_matches_jax(nq, N, d, k, p_live):
    rng = np.random.default_rng(nq * 1000 + N)
    q, vecs = _unit(rng, nq, d), _unit(rng, N, d)
    live = rng.random(N) < p_live
    out = ops.topk_search(*_t(q, vecs, live), k)
    _assert_parity(topk_search_pallas(jnp.asarray(q), jnp.asarray(vecs),
                                      jnp.asarray(live), k, interpret=True),
                   out)
    _assert_parity(jref.topk_search(jnp.asarray(q), jnp.asarray(vecs),
                                    jnp.asarray(live), k), out)


@pytest.mark.parametrize("case", ["k_gt_tile", "k_gt_live", "n_lt_k",
                                  "all_dead_nq1"])
def test_topk_search_edge_cases_match_jax(case):
    """The edge cases ``tests/test_kernels.py`` pins on the TPU kernel:
    rows with fewer than k live matches pad with (NEG, -1)."""
    rng = np.random.default_rng(7)
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
    q = rng.standard_normal((nq, d)).astype(np.float32)
    vecs = rng.standard_normal((N, d)).astype(np.float32)
    s, i = ops.topk_search(*_t(q, vecs, live), k)
    _padding_contract(s, i, int(live.sum()))
    _assert_parity(topk_search_pallas(jnp.asarray(q), jnp.asarray(vecs),
                                      jnp.asarray(live), k, interpret=True,
                                      **kw), (s, i))


def test_topk_search_tie_order_matches_jax():
    """Equal scores keep the lower row, as lax.top_k does."""
    rng = np.random.default_rng(3)
    base = _unit(rng, 6, 16)
    vecs = np.concatenate([base, base, base[::-1]])     # every row 3 times
    q = base[:2] + 0.0
    live = np.ones(len(vecs), bool)
    live[4] = False
    s, i = ops.topk_search(*_t(q, vecs, live), 7)
    js, ji = topk_search_pallas(jnp.asarray(q), jnp.asarray(vecs),
                                jnp.asarray(live), 7, interpret=True)
    assert (i.numpy() == np.asarray(ji)).all()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    # the three copies of the query's own row come first, lowest row first
    assert i[0, :3].tolist() == [0, 6, 17]


def _rising(nq, n, d):
    """Rows whose scores rise with the row index (every row beats every
    earlier one: the register filter's worst case), every 7th row dead."""
    vecs = np.zeros((n, d), np.float32)
    vecs[:, 0] = np.arange(n, dtype=np.float32) / n
    vecs[:, 1] = 0.25
    q = np.zeros((nq, d), np.float32)
    q[:, 0] = 1.0
    q[:, 1] = np.arange(nq, dtype=np.float32) / 4
    live = np.ones(n, bool)
    live[::7] = False
    return q, vecs, live


def _repeated(rng, nq, reps_of=100, d=16):
    """Grid-valued rows (exact fp32 scores) each repeated across sub-tiles
    and tiles, so equal scores are real ties."""
    base = _grid(rng, reps_of, d)
    vecs = np.concatenate([base, base, base[::-1]])
    live = rng.random(len(vecs)) < 0.9
    return _grid(rng, nq, d), vecs, live


@pytest.mark.parametrize("k", [1, 16, 128])
def test_topk_search_rising_corpus_matches_jax(k):
    q, vecs, live = _rising(3, 600, 16)
    s, i = ops.topk_search(*_t(q, vecs, live), k)
    js, ji = jref.topk_search(*(jnp.asarray(a) for a in (q, vecs, live)), k)
    assert (i.numpy() == np.asarray(ji)).all()
    assert (s.numpy() == np.asarray(js)).all()
    assert (i.numpy()[:, 0] == 599).all()      # the last live row first


@pytest.mark.parametrize("k", [1, 7, 16, 128])
@pytest.mark.parametrize("nq", [1, 63, 65, 130])
def test_topk_search_repeated_rows_match_jax(nq, k):
    """Exact scores with every row three times: ids and scores equal the
    JAX reference's, equal scores with the lower row first."""
    q, vecs, live = _repeated(np.random.default_rng(nq * 10 + k), nq)
    s, i = ops.topk_search(*_t(q, vecs, live), k)
    js, ji = jref.topk_search(*(jnp.asarray(a) for a in (q, vecs, live)), k)
    assert (i.numpy() == np.asarray(ji)).all()
    assert (s.numpy() == np.asarray(js)).all()


def _block_lists(q, vecs, live, k, tile, n_lists):
    """What the card kernel hands its wrapper, by the plain version: block b
    of n_lists folds tiles b, b + n_lists, ... into one list per query."""
    n_tiles = -(-len(vecs) // tile)
    lists_s, lists_i = [], []
    for b in range(n_lists):   # each block's list: its tiles' rows in order
        rows = np.concatenate([np.arange(t * tile, min((t + 1) * tile,
                                                       len(vecs)))
                               for t in range(b, n_tiles, n_lists)])
        ls, li = ref.topk_search(*_t(q, vecs[rows], live[rows]), k)
        li = torch.where(li >= 0, torch.from_numpy(rows)[li.long()].int(), li)
        lists_s.append(ls)
        lists_i.append(li)
    return torch.cat(lists_s, 1), torch.cat(lists_i, 1)


@pytest.mark.parametrize("n_lists", [1, 3, 8])
def test_merge_by_row_matches_jax(n_lists):
    """The card wrapper's merge: per-block lists (block b holding tiles b,
    b + G, ...) in any list order give the global top-k of lax.top_k."""
    rng = np.random.default_rng(n_lists)
    q, vecs, live = _repeated(rng, 5, reps_of=60)
    k = 7
    got = tts.merge_by_row(*_block_lists(q, vecs, live, k, 16, n_lists), k)
    js, ji = jref.topk_search(*(jnp.asarray(a) for a in (q, vecs, live)), k)
    assert (got[1].numpy() == np.asarray(ji)).all()
    assert (got[0].numpy() == np.asarray(js)).all()


TILE_ROWS = 256        # csrc/topk_search.cu's corpus rows per tile
H100_LISTS = 2 * 132   # the wrapper's lists on an H100: two blocks per SM


def _many_tiles(rng, nq, n_lists, d=32):
    """Grid-valued rows over 3 * n_lists + 1 tiles, so block b of n_lists
    folds tiles b, b + n_lists, ... (three or four) into one list. Each
    query's best row, 0.5 sign(q) (the highest score a grid row reaches),
    is planted in tiles b, b + n_lists and b + 2 n_lists of block
    b = n_lists // 2 at other offsets, so its copies tie across that
    block's tiles; the random rows below them tie among themselves across
    every block's tiles. The planted rows are live; they come back too,
    ``[nq, 3]`` in row order."""
    n = 3 * n_lists * TILE_ROWS + 77
    q, vecs = _grid(rng, nq, d), _grid(rng, n, d)
    live = rng.random(n) < 0.9
    best, b, j = np.sign(q) / 2, n_lists // 2, np.arange(nq)
    planted = np.stack([b * TILE_ROWS + j,
                        (b + n_lists) * TILE_ROWS + 50 + j[::-1],
                        (b + 2 * n_lists) * TILE_ROWS + 10 + j], 1)
    vecs[planted[:, 0]] = vecs[planted[:, 1]] = vecs[planted[:, 2]] = best
    live[planted] = True
    return q, vecs, live, planted


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("n_lists", [1, 3, H100_LISTS])
def test_topk_search_ties_across_a_blocks_tiles_match_jax(n_lists, k):
    """Exact ties between the tiles one card block folds: the plain version
    and the card's list-then-merge order, simulated by the plain version,
    both equal the JAX reference, ids and scores."""
    q, vecs, live, planted = _many_tiles(
        np.random.default_rng(n_lists * 7 + k), 6, n_lists)
    js, ji = jref.topk_search(*(jnp.asarray(a) for a in (q, vecs, live)), k)
    s, i = ops.topk_search(*_t(q, vecs, live), k)
    assert (i.numpy() == np.asarray(ji)).all()
    assert (s.numpy() == np.asarray(js)).all()
    ms, mi = tts.merge_by_row(*_block_lists(q, vecs, live, k, TILE_ROWS,
                                            n_lists), k)
    assert (mi.numpy() == np.asarray(ji)).all()
    assert (ms.numpy() == np.asarray(js)).all()
    # the planted copies lead, lowest row first
    assert (i.numpy()[:, :3] == planted[:, :k]).all()


# -- merge_candidates / probe -------------------------------------------------


@pytest.mark.parametrize("c,k", [(12, 4), (3, 5)])
def test_merge_candidates_matches_jax(c, k):
    rng = np.random.default_rng(c)
    cand_s = np.round(rng.standard_normal((4, c)), 1).astype(np.float32)
    cand_s[0, :2] = ref.NEG                                   # dead entries
    cand_i = rng.permutation(100)[:4 * c].reshape(4, c).astype(np.int32)
    js, ji = jfr.merge_candidates(jnp.asarray(cand_s), jnp.asarray(cand_i), k)
    ts, ti = ref.merge_candidates(*_t(cand_s, cand_i), k)
    assert (ti.numpy() == np.asarray(ji)).all()     # ties: rounded scores
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_probe_matches_jax():
    rng = np.random.default_rng(11)
    q, cent = _unit(rng, 6, 16), _unit(rng, 8, 16)
    cent[5] = cent[2]                                         # a tie
    jp = np.asarray(jfr._probe(jnp.asarray(q), jnp.asarray(cent), 3))
    tp = ref.probe(*_t(q, cent), 3)
    assert tp.dtype == torch.int32
    assert (tp.numpy() == jp).all()


# -- ivf_topk -----------------------------------------------------------------


def _packed(rng, nlist, cap_b, d, p_ok, dup=False):
    rows = nlist * cap_b
    vecs = _unit(rng, rows, d)
    if dup:                                # equal scores inside a bucket
        vecs[1::2] = vecs[0::2]
    ok = (rng.random(rows) < p_ok).astype(np.int8)
    slot = np.where(ok > 0, rng.permutation(rows) + 3, -1).astype(np.int32)
    return vecs, slot, ok


@pytest.mark.parametrize("nq,nlist,cap_b,d,nprobe,k,p_ok,dup", [
    (4, 4, 32, 16, 2, 5, 0.5, False),
    (3, 4, 16, 32, 4, 20, 0.4, False),    # k > cap_b and > live per bucket
    (5, 4, 24, 16, 3, 6, 0.7, True),      # ties inside buckets
    (1, 4, 8, 16, 2, 4, 0.0, False),      # every bucket dead
])
def test_ivf_topk_matches_jax(nq, nlist, cap_b, d, nprobe, k, p_ok, dup):
    rng = np.random.default_rng(nq * 31 + cap_b)
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    vecs, slot, ok = _packed(rng, nlist, cap_b, d, p_ok, dup)
    out = ops.ivf_topk(*_t(q, cent, vecs, slot, ok), nprobe, k)
    j_in = [jnp.asarray(a) for a in (q, cent, vecs, slot, ok)]
    _assert_parity(jfr.ivf_topk_pallas(*j_in, nprobe, k, interpret=True), out)
    _assert_parity(jfr.ivf_topk_xla(*j_in, nprobe, k), out)
    if dup:   # exact tie order against the TPU kernel's argmax rounds
        ji = np.asarray(jfr.ivf_topk_pallas(*j_in, nprobe, k,
                                            interpret=True)[1])
        assert (out[1].numpy() == ji).all()


# -- dispatch and the CUDA wrappers' input checks -------------------------------


def test_dispatch_rejects_mixed_and_unknown_devices():
    q = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="several devices"):
        ops.topk_search(q, torch.zeros(4, 8, device="meta"),
                        torch.ones(4, dtype=torch.bool), 2)
    meta = [torch.zeros(s, device="meta") for s in ((2, 8), (4, 8), (4,))]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.topk_search(*meta, 2)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise before building or
    launching anything; nothing falls back to the plain version."""
    q, v = torch.zeros(2, 8), torch.zeros(4, 8)
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="must be on"):
        tts.topk_search_cuda(q, v, live, 2)
    with pytest.raises(ValueError, match="must be on"):
        tfr.ivf_topk_cuda(q, torch.zeros(2, 8), v, torch.zeros(4, dtype=torch.int32),
                          live, 1, 2)
    codes, scale = torch.zeros(4, 8, dtype=torch.int8), torch.ones(8)
    with pytest.raises(ValueError, match="must be on"):
        tqs.quant_score_cuda(q, codes, scale)
    with pytest.raises(ValueError, match="must be on"):
        tfr.sq8_topk_cuda(q, codes, scale, live, 2)
    with pytest.raises(ValueError, match="must be on"):
        tfr.pq_topk_cuda(q, torch.zeros(2, 256, 4), torch.zeros(2, 8),
                         torch.zeros(4, 2, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32), live, 1, 2)
    with pytest.raises(ValueError, match="must be on"):
        tfa.flash_attention_cuda(torch.zeros(1, 2, 4, 16),
                                 torch.zeros(1, 1, 4, 16),
                                 torch.zeros(1, 1, 4, 16), True)
    bf = [torch.zeros(s, dtype=torch.bfloat16) for s in ((1, 2, 4, 64),
                                                         (1, 1, 4, 64),
                                                         (1, 1, 4, 64))]
    with pytest.raises(ValueError, match="must be on"):
        tfa.flash_attention_cuda(*bf, True)
    assert ops.launch_counts() == {"topk_search": 0, "quant_score": 0,
                                   "ivf_topk": 0, "sq8_topk": 0,
                                   "pq_topk": 0, "flash_attention": 0}


def test_compare_topk_flags_a_wrong_id():
    s = np.array([[0.9, 0.5, 0.1]], np.float32)
    i = np.array([[4, 2, 7]], np.int32)
    assert compare_topk(s, i, s, i)["violations"] == 0
    assert compare_topk(s, i, s, np.array([[4, 3, 7]], np.int32))[
        "violations"] == 1
    tied = np.array([[0.9, 0.9, 0.1]], np.float32)   # near tie: either order
    assert compare_topk(tied, i, tied, np.array([[2, 4, 7]], np.int32))[
        "violations"] == 0


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nq,N,d,k,p_live", [
    (3, 32, 8, 8, 1.0), (2, 64, 8, 6, 0.05), (1, 5, 8, 8, 1.0),
    (1, 129, 24, 4, 0.0), (70, 3000, 32, 128, 0.9), (5, 4101, 48, 16, 0.8)])
def test_topk_search_kernel_matches_plain(cuda_device, nq, N, d, k, p_live):
    rng = np.random.default_rng(N)
    q, vecs = _t(_unit(rng, nq, d), _unit(rng, N, d))
    live = torch.from_numpy(rng.random(N) < p_live)
    args = [a.to(cuda_device) for a in (q, vecs, live)]
    got = compare_topk(*ref.topk_search(*args, k), *ops.topk_search(*args, k))
    assert got["violations"] == 0, got


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nlist,cap_b,d,nprobe,k,p_ok,dup", [
    (4, 4, 32, 16, 2, 5, 0.5, False), (3, 4, 16, 32, 4, 20, 0.4, False),
    (5, 4, 24, 16, 3, 6, 0.7, True), (1, 4, 8, 16, 2, 4, 0.0, False)])
def test_ivf_topk_kernel_matches_plain(cuda_device, nq, nlist, cap_b, d,
                                       nprobe, k, p_ok, dup):
    rng = np.random.default_rng(cap_b)
    q, cent = _unit(rng, nq, d), _unit(rng, nlist, d)
    args = [a.to(cuda_device) for a in _t(q, cent, *_packed(
        rng, nlist, cap_b, d, p_ok, dup))]
    got = compare_topk(*ref.ivf_topk(*args, nprobe, k),
                       *ops.ivf_topk(*args, nprobe, k))
    assert got["violations"] == 0, got


def _grid(rng, n, d):
    """Entries in {-0.5, -0.25, 0, 0.25, 0.5}: every dot product is exact in
    fp32 whatever the summation order, so the kernel's scores equal the
    plain version's bit for bit and ties are real ties."""
    return (rng.integers(-2, 3, (n, d)) / 4).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 128])
def test_topk_search_kernel_tie_order(cuda_device, k):
    """Every row three times, the copies in other sub-tiles and corpus
    tiles, on exact scores: ids and scores equal the plain version's, so
    the kernel keeps the lower row first on equal scores."""
    rng = np.random.default_rng(k)
    base = _grid(rng, 1000, 32)
    vecs = np.concatenate([base, base, base[::-1]])
    live = rng.random(len(vecs)) < 0.9
    args = [a.to(cuda_device) for a in _t(_grid(rng, 6, 32), vecs, live)]
    want, got = ref.topk_search(*args, k), ops.topk_search(*args, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nlist,cap_b,d,nprobe,k", [
    (5, 4, 24, 16, 3, 6), (9, 16, 256, 64, 5, 128)])
def test_ivf_topk_kernel_tie_order(cuda_device, nq, nlist, cap_b, d, nprobe,
                                   k):
    """Exact scores with every even packed row repeated in the next one:
    ids and scores equal the plain version's (the lower packed row first
    inside a bucket, the earlier probe first across buckets)."""
    rng = np.random.default_rng(cap_b)
    vecs, slot, ok = _packed(rng, nlist, cap_b, d, 0.7)
    vecs = _grid(rng, nlist * cap_b, d)
    vecs[1::2] = vecs[0::2]
    args = [a.to(cuda_device) for a in _t(_grid(rng, nq, d),
                                          _unit(rng, nlist, d), vecs, slot,
                                          ok)]
    want, got = ref.ivf_topk(*args, nprobe, k), ops.ivf_topk(*args, nprobe, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _kernel_lists(q, vecs, live, k, n_lists):
    """The kernel's C entry point launched with n_lists blocks (block b
    folds tiles b, b + n_lists, ... into one list), merged as the wrapper
    merges."""
    nq, dev = q.shape[0], q.device
    lib, fn = _build.entry("topk_search", 5, 5)
    out_s = torch.empty((nq, n_lists, k), device=dev)
    out_i = torch.empty((nq, n_lists, k), dtype=torch.int32, device=dev)
    _build.check(lib, "topk_search", fn(
        q.data_ptr(), vecs.data_ptr(), live.view(torch.uint8).data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), nq, vecs.shape[0], vecs.shape[1],
        k, n_lists, torch.cuda.current_stream(dev).cuda_stream))
    return tts.merge_by_row(out_s.view(nq, -1), out_i.view(nq, -1), k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("n_lists", ["wrapper", 1, 3])
def test_topk_search_kernel_rising_corpus(cuda_device, n_lists, k):
    """Every row beats a stale threshold, also that of a list that has
    folded tens of tiles before it (1 or 3 blocks through the C entry
    point): ids and scores exactly equal."""
    args = [a.to(cuda_device) for a in _t(*_rising(5, 20000, 16))]
    want = ref.topk_search(*args, k)
    got = (ops.topk_search(*args, k) if n_lists == "wrapper"
           else _kernel_lists(*args, k, n_lists))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 16, 128])
@pytest.mark.parametrize("nq", [1, 63, 65, 130])
def test_topk_search_kernel_repeated_rows(cuda_device, nq, k):
    """Grid-valued rows repeated across sub-tiles and tiles: ids and scores
    exactly equal the plain version's, ties included."""
    q, vecs, live = _repeated(np.random.default_rng(nq + k), nq,
                              reps_of=1000, d=32)
    args = [a.to(cuda_device) for a in _t(q, vecs, live)]
    want, got = ref.topk_search(*args, k), ops.topk_search(*args, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("n_lists", [1, 3, "wrapper"])
def test_topk_search_kernel_ties_across_a_blocks_tiles(cuda_device, n_lists,
                                                       k):
    """Exact ties between the tiles one block folds into one list (a stale
    threshold carried from tile to tile): ids and scores equal the plain
    version's. ``wrapper``: the wrapper's own grid, two blocks per SM, over
    more than three tiles per block."""
    g = (tts.BLOCKS_PER_SM * torch.cuda.get_device_properties(
        cuda_device).multi_processor_count if n_lists == "wrapper"
         else n_lists)
    q, vecs, live, planted = _many_tiles(np.random.default_rng(g + k), 70, g)
    args = [a.to(cuda_device) for a in _t(q, vecs, live)]
    want = ref.topk_search(*args, k)
    got = (ops.topk_search(*args, k) if n_lists == "wrapper"
           else _kernel_lists(*args, k, n_lists))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1][:, :3].cpu().numpy() == planted[:, :k]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 16])
def test_topk_search_kernel_dead_tiles(cuda_device, k):
    """Tiles with no live row among live ones, and a corpus with none."""
    rng = np.random.default_rng(k)
    q, vecs = _unit(rng, 7, 48), _unit(rng, 9000, 48)
    live = np.zeros(9000, bool)
    live[1000:1100] = True
    live[5000:5003] = True
    for mask in (live, np.zeros(9000, bool)):
        args = [a.to(cuda_device) for a in _t(q, vecs, mask)]
        want, got = ref.topk_search(*args, k), ops.topk_search(*args, k)
        assert compare_topk(*want, *got)["violations"] == 0
        _padding_contract(got[0].cpu(), got[1].cpu(), int(mask.sum()))
