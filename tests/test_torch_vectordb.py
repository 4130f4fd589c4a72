"""The port's vector DB against the JAX package's, on the CPU.

State is carried across with ``repro_torch.convert`` (the two packages'
random draws differ), then both DBs answer the same seeded queries, before
and after the same mutations. Tolerance (``repro_torch.kernels.parity``):
scores within 1e-5 (fp32, the summation order differs), ids equal outside
groups of near-tied scores. TF32 is off for every fp32 product.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes; the suite runs several workers at once, so one intra-op
# thread each keeps torch from crowding the timing-sensitive tests
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.interfaces import Chunk as JChunk  # noqa: E402
from repro.core.vectordb import DBConfig as JDBConfig  # noqa: E402
from repro.core.vectordb import JaxVectorDB  # noqa: E402
from repro.core.vectordb import kmeans as jax_kmeans  # noqa: E402
from repro.core.vectordb import merge_topk as jax_merge_topk  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.interfaces import Chunk  # noqa: E402
from repro_torch.core.vectordb import (DBConfig, TorchVectorDB,  # noqa: E402
                                       _flat_search, assign, fill_buckets,
                                       kmeans, merge_topk)
from repro_torch.kernels.parity import compare_topk  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIM = 16
N = 192


def _corpus(n=N, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    return vecs / np.linalg.norm(vecs, axis=1, keepdims=True)


def _chunks(cls, n, doc0=0):
    return [cls(chunk_id=-1, doc_id=doc0 + i // 4, text=f"c{i}")
            for i in range(n)]


def _queries(nq=8, seed=1):
    rng = np.random.default_rng(seed)
    return (_corpus()[:nq] + 0.02 * rng.standard_normal(
        (nq, DIM))).astype(np.float32)


def _jax_db(index_type, use_kernel, n=N, **kw):
    cfg = dict(index_type=index_type, dim=DIM, capacity=n + 96, nlist=4,
               nprobe=2, flat_capacity=48, pq_m=4, use_kernel=use_kernel)
    cfg.update(kw)
    db = JaxVectorDB(JDBConfig(**cfg))
    db.insert(_corpus(n), _chunks(JChunk, n))
    db.build_index()
    return db


def _assert_same(jdb, tdb, q, k=5):
    js, ji = jdb._search_arrays(jnp.asarray(q), k)
    ts, ti = tdb.search_arrays(torch.from_numpy(q), k)
    got = compare_topk(np.asarray(js), np.asarray(ji), ts, ti)
    assert got["violations"] == 0, got


# (index, quant) x rung; the quant="none" cases keep their original ids
DB_CASES = [
    pytest.param(rung, index_type, quant, id="-".join(
        [rung, index_type] + ([quant] if quant != "none" else [])))
    for index_type, quant in [("flat", "none"), ("ivf", "none"),
                              ("flat", "sq8"), ("ivf", "pq"),
                              ("ivf", "sq8"), ("flat", "pq")]
    for rung in ("off", "op", "fused")]


@pytest.mark.parametrize("rung,index_type,quant", DB_CASES)
def test_matches_jax_db_before_and_after_mutation(rung, index_type, quant,
                                                  monkeypatch):
    """Every (index, quant) pair on every rung. The quantized state (sq8
    codes and scale, PQ codes and codebook) goes across with the rest: the
    reference's PQ codebook comes from ``jax.random``."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")
    jdb = _jax_db(index_type, False if rung == "off" else rung, quant=quant)
    tdb = convert.db_from_jax(jdb, device="cpu")
    assert tdb._kernel == rung and tdb.cfg.quant == quant
    assert (tdb.packed is not None) == (rung == "fused" and index_type == "ivf")
    if tdb.packed is not None:   # PQ mirrors codes, the others fp32 rows
        assert set(tdb.packed) == {"slot", "codes" if quant == "pq"
                                   else "vecs"}
    q = _queries()
    _assert_same(jdb, tdb, q)
    fresh = _corpus(10, seed=3)
    for db, cls in ((jdb, JChunk), (tdb, Chunk)):
        assert db.remove(2) == 4
        db.remove(31)
        db.insert(fresh.copy(), _chunks(cls, 10, doc0=900))
    assert tdb.stats()["fresh"] == jdb.stats()["fresh"] == 10
    _assert_same(jdb, tdb, q)
    # the port's fused rung against its own plain rung on the same state
    s_off, i_off = tdb.search_arrays(torch.from_numpy(q), 5, rung="off")
    s_k, i_k = tdb.search_arrays(torch.from_numpy(q), 5)
    assert compare_topk(s_off, i_off, s_k, i_k)["violations"] == 0


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_hybrid_lists_are_disjoint_and_merge_as_jax(index_type):
    """The main index and the freshness buffer never return the same slot,
    so the port's merge (a stable sort, no dedup) equals the reference's
    ``merge_topk`` on the same two lists, ties included."""
    tdb = TorchVectorDB(DBConfig(index_type=index_type, dim=DIM,
                                 capacity=N + 96, nlist=4, nprobe=4,
                                 flat_capacity=48), device="cpu")
    base = _corpus()
    tdb.insert(base, _chunks(Chunk, N))
    tdb.build_index()
    tdb.remove(3)
    tdb.insert(base[:20].copy(), _chunks(Chunk, 20, doc0=700))  # exact ties
    snap = tdb._snapshot()
    q = torch.from_numpy(_queries())
    main = tdb._search_main(q, snap["live"] & snap["indexed"], 6, snap, "off")
    fresh = _flat_search(q, snap["vectors"],
                         tdb._mask(snap["live"] & ~snap["indexed"]), 6)
    for r in range(q.shape[0]):
        a, b = main[1][r], fresh[1][r]
        assert not set(a[a >= 0].tolist()) & set(b[b >= 0].tolist())
    ts, ti = merge_topk(*main, *fresh, 6)
    js, ji = jax_merge_topk(*(t.numpy() for t in (*main, *fresh)), 6)
    assert (ti.numpy() == ji).all()
    np.testing.assert_array_equal(ts.numpy(), js)
    # each query's own row and its fresh copy come first; on an exact tie
    # (the flat index scores both in one product) the main index's wins
    for r in range(q.shape[0]):
        assert sorted(ti[r, :2].tolist()) == [r, r + N]
        if ts[r, 0] == ts[r, 1]:
            assert ti[r, 0] == r
    if index_type == "flat":
        assert (ts[:, 0] == ts[:, 1]).all()


def test_cold_start_matches_jax():
    """Before any build_index every rung brute-forces the live rows."""
    jdb = JaxVectorDB(JDBConfig(dim=DIM, capacity=64, nlist=4))
    tdb = TorchVectorDB(DBConfig(dim=DIM, capacity=64, nlist=4,
                                 use_kernel="fused"), device="cpu")
    jdb.insert(_corpus(40), _chunks(JChunk, 40))
    tdb.insert(torch.from_numpy(_corpus(40)), _chunks(Chunk, 40))
    _assert_same(jdb, tdb, _queries(4), k=6)


def test_threshold_rebuild_refreshes_packed_mirror():
    """Inserts past the buffer threshold rebuild the index and the packed
    mirror; the kernel rung still agrees with the plain rung."""
    tdb = TorchVectorDB(DBConfig(dim=DIM, capacity=N + 96, nlist=4, nprobe=2,
                                 flat_capacity=48, use_kernel="fused"),
                        device="cpu")
    tdb.insert(_corpus(), _chunks(Chunk, N))
    tdb.build_index()
    slot0 = tdb.packed["slot"].clone()
    tdb.insert(_corpus(30, seed=9), _chunks(Chunk, 30, doc0=500))
    assert tdb.counters["rebuilds"] == 1 and tdb.stats()["fresh"] == 30
    tdb.insert(_corpus(10, seed=8), _chunks(Chunk, 10, doc0=600))   # 40 >= 36
    assert tdb.counters["rebuilds"] == 2
    assert tdb.stats()["fresh"] == 0 and tdb.counters["flat_fill"] >= 0.75
    assert not torch.equal(tdb.packed["slot"], slot0)
    assert int((tdb.packed["slot"] >= 0).sum()) == N + 40
    q = torch.from_numpy(_queries())
    assert compare_topk(*tdb.search_arrays(q, 5, rung="off"),
                        *tdb.search_arrays(q, 5))["violations"] == 0


def test_capacity_overflow_raises_memory_error():
    tdb = TorchVectorDB(DBConfig(dim=DIM, capacity=8), device="cpu")
    tdb.insert(_corpus(6), _chunks(Chunk, 6))
    with pytest.raises(MemoryError, match="vector store full"):
        tdb.insert(_corpus(3), _chunks(Chunk, 3))
    assert tdb.stats()["slots"] == 6


def test_bucket_spill_matches_jax_and_overflow_raises():
    """Full buckets spill to the least-full one exactly as the reference
    does; when every bucket is full the build raises MemoryError."""
    jdb = _jax_db("ivf", False, bucket_cap=52)     # 192 rows, 4 x 52 slots
    cent = torch.from_numpy(np.array(jdb.centroids))
    live = torch.from_numpy(np.nonzero(jdb.live)[0])
    x = torch.from_numpy(_corpus())
    asg = assign(x, cent, rows=live)
    assert int(torch.bincount(asg, minlength=4).max()) > 52   # spills happen
    buckets, overflow = fill_buckets(live, asg, 4, 52)
    assert overflow == 0
    assert (buckets.numpy() == jdb.buckets).all()
    # no spill: the vectorized path lays rows out as the sequential rule
    buckets, _ = fill_buckets(live, asg, 4, 128)
    ref = np.full((4, 128), -1, np.int32)
    for b in range(4):
        rows = live.numpy()[asg.numpy() == b]
        ref[b, :len(rows)] = rows
    assert (buckets.numpy() == ref).all()
    tdb = TorchVectorDB(DBConfig(dim=DIM, capacity=N, nlist=4, bucket_cap=40),
                        device="cpu")
    tdb.insert(_corpus(), _chunks(Chunk, N))
    with pytest.raises(MemoryError, match="overflowed IVF buckets"):
        tdb.build_index()


def test_set_nprobe_matches_jax():
    jdb = _jax_db("ivf", False)
    tdb = convert.db_from_jax(jdb, use_kernel="fused", device="cpu")
    q = _queries()
    for nprobe in (1, 3, 99):        # 99: clamped to nlist at search time
        jdb.set_nprobe(nprobe)
        tdb.set_nprobe(nprobe)
        assert tdb.cfg.nprobe == nprobe
        _assert_same(jdb, tdb, q)
    tdb.set_nprobe(0)
    assert tdb.cfg.nprobe == 1


def test_stats_and_counters_match_jax():
    jdb = _jax_db("ivf", "fused")
    tdb = TorchVectorDB(DBConfig(dim=DIM, capacity=N + 96, nlist=4, nprobe=2,
                                 flat_capacity=48, use_kernel="fused"),
                        device="cpu")
    tdb.insert(_corpus(), _chunks(Chunk, N))
    tdb.build_index()
    q = _queries()
    jdb.search(q, 5)
    res = tdb.search(q, 5)
    assert len(res) == len(q) and res[0].chunk_ids.dtype == np.int32
    js, ts = jdb.stats(), tdb.stats()
    assert set(js) == set(ts)
    for key in ("live", "slots", "vector_bytes", "index_bytes", "fresh",
                "inserts", "removals", "searches", "rebuilds",
                "fused_searches"):
        assert js[key] == ts[key], key
    assert tdb.get_chunk(5).text == "c5"
    assert [c.text for c in tdb.get_chunks([1, 2])] == ["c1", "c2"]


def test_kmeans_matches_jax_on_injected_init():
    """From the reference's initial draw, the port's Lloyd iterations give
    the same assignment, except for rows whose two best centroids are
    within 1e-6 (a near tie the summation order may flip)."""
    x = _corpus(256, seed=4)
    k, iters = 4, 8
    idx = jax.random.choice(jax.random.PRNGKey(0), 256, (k,), replace=False)
    cent_j = np.asarray(jax_kmeans(jnp.asarray(x), k, iters))
    cent_t = kmeans(torch.from_numpy(x), k, iters,
                    init=torch.from_numpy(x[np.asarray(idx)]))
    np.testing.assert_allclose(cent_t.numpy(), cent_j, atol=1e-5)
    scores = x @ cent_j.T
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= 1e-6
    a_j = scores.argmax(1)
    a_t = assign(torch.from_numpy(x), cent_t).numpy()
    assert clear.mean() > 0.9
    assert (a_j[clear] == a_t[clear]).all()


def test_torch_db_draws_its_own_centroids():
    """Without injected state the port trains its own index (torch RNG):
    every live row lands in exactly one bucket."""
    tdb = TorchVectorDB(DBConfig(dim=DIM, capacity=N, nlist=4), device="cpu")
    tdb.insert(_corpus(), _chunks(Chunk, N))
    tdb.build_index()
    members = tdb.buckets[tdb.bucket_live]
    assert sorted(members.tolist()) == list(range(N))
    norms = torch.linalg.norm(tdb.centroids, dim=1)
    assert torch.allclose(norms, torch.ones(4), atol=1e-5)


def test_registry_names_and_unported_quant():
    """Both backends build every quant; an unknown quant and a dim that
    the PQ subspaces do not divide raise ValueError."""
    db = registry.create("vectordb", "torch_fused", dim=DIM, capacity=32,
                         nlist=2, device="cpu")
    assert db._kernel == "fused"
    assert registry.create("vectordb", "torch", dim=DIM, capacity=32,
                           device="cpu")._kernel == "off"
    with pytest.raises(ValueError, match="requires use_kernel='fused'"):
        registry.create("vectordb", "torch_fused", dim=DIM, use_kernel="op",
                        device="cpu")
    for quant in ("sq8", "pq"):
        assert registry.create("vectordb", "torch_fused", quant=quant,
                               dim=DIM, pq_m=4, device="cpu").cfg.quant == quant
    with pytest.raises(ValueError, match="quant must be one of"):
        TorchVectorDB(DBConfig(dim=DIM, quant="opq"), device="cpu")
    with pytest.raises(ValueError, match="not a multiple of pq_m"):
        TorchVectorDB(DBConfig(dim=DIM, quant="pq", pq_m=5), device="cpu")


# -- the quantized DB ------------------------------------------------------------


def _mutate_and_rebuild_free(db, cls):
    db.remove(5)
    db.insert(_corpus(12, seed=6), _chunks(cls, 12, doc0=800))


def test_sq8_training_matches_jax_without_injection():
    """``_train_sq`` in fp32 torch gives the reference's scale and codes bit
    for bit: the scale from the live rows only, codes for every used slot,
    code 0 for slots never filled. No state is carried across."""
    jdb = JaxVectorDB(JDBConfig(index_type="flat", quant="sq8", dim=DIM,
                                capacity=N + 96, flat_capacity=48))
    tdb = TorchVectorDB(DBConfig(index_type="flat", quant="sq8", dim=DIM,
                                 capacity=N + 96, flat_capacity=48),
                        device="cpu")
    for db, cls in ((jdb, JChunk), (tdb, Chunk)):
        assert db.sq_codes is None
        db.insert(_corpus(), _chunks(cls, N))
        db.remove(7)                       # dead rows: no part in the scale
        db.build_index()
    assert tdb.sq_codes.dtype == torch.int8 and tdb.sq_scale.dtype == \
        torch.float32
    np.testing.assert_array_equal(tdb.sq_scale.numpy(), jdb.sq_scale)
    np.testing.assert_array_equal(tdb.sq_codes.numpy(), jdb.sq_codes)
    assert not tdb.sq_codes[N:].any()
    _assert_same(jdb, tdb, _queries())


@pytest.mark.parametrize("rung", ["off", "op", "fused"])
def test_sq8_without_hybrid_scores_late_rows_as_code_zero(rung,
                                                          monkeypatch):
    """Without the freshness buffer, rows inserted after the build are live
    in the main index with code 0, so the flat sq8 search scores them 0,
    as the reference does."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")
    jdb = _jax_db("flat", False if rung == "off" else rung, quant="sq8",
                  use_hybrid=False)
    tdb = convert.db_from_jax(jdb, device="cpu")
    for db, cls in ((jdb, JChunk), (tdb, Chunk)):
        _mutate_and_rebuild_free(db, cls)
    q = np.concatenate([_queries(4), _corpus(12, seed=6)[:4]])
    _assert_same(jdb, tdb, q, k=N)          # every row, the late ones at 0
    s, i = tdb.search_arrays(torch.from_numpy(q), N)
    late = (i >= N) & (i < N + 12)
    assert late.any() and (s[late] == 0).all()


def test_threshold_rebuild_refreshes_pq_packed_mirror():
    """Inserts past the buffer threshold retrain the PQ codebook, recode
    the live rows and rebuild the packed codes; the ``pq_topk`` rung still
    agrees with the plain rung, and the late rows now have codes."""
    tdb = TorchVectorDB(DBConfig(dim=DIM, quant="pq", pq_m=4, capacity=N + 96,
                                 nlist=4, nprobe=2, flat_capacity=48,
                                 use_kernel="fused"), device="cpu")
    tdb.insert(_corpus(), _chunks(Chunk, N))
    tdb.build_index()
    codes0, cb0 = tdb.packed["codes"].clone(), tdb.pq_codebook.clone()
    assert tdb.packed["codes"].dtype == torch.uint8   # one byte a code
    assert tdb.pq_codes.dtype == torch.int32          # as in the reference
    assert not tdb.pq_codes[N:].any()
    tdb.insert(_corpus(40, seed=9), _chunks(Chunk, 40, doc0=500))  # 40 >= 36
    assert tdb.counters["rebuilds"] == 2 and tdb.stats()["fresh"] == 0
    assert tdb.pq_codes[N:N + 40].any()
    assert int((tdb.packed["slot"] >= 0).sum()) == N + 40
    assert not torch.equal(tdb.packed["codes"][:len(codes0)], codes0) or \
        not torch.equal(tdb.pq_codebook, cb0)
    slot = tdb.packed["slot"]
    assert torch.equal(tdb.packed["codes"],
                       tdb.pq_codes[slot.clamp(min=0).long()].to(torch.uint8))
    q = torch.from_numpy(_queries())
    assert compare_topk(*tdb.search_arrays(q, 5, rung="off"),
                        *tdb.search_arrays(q, 5))["violations"] == 0


@pytest.mark.parametrize("index_type,quant", [("flat", "sq8"), ("ivf", "pq"),
                                              ("ivf", "sq8"), ("flat", "pq")])
def test_quant_stats_match_jax(index_type, quant, monkeypatch):
    """``stats`` equals the reference's key for key, its quantized
    ``index_bytes`` terms included, after the same build, searches and
    mutations (each DB trains its own index)."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "xla")
    jdb = _jax_db(index_type, "fused", quant=quant)
    tdb = TorchVectorDB(DBConfig(**{
        f: getattr(jdb.cfg, f) for f in DBConfig.__dataclass_fields__}),
        device="cpu")
    tdb.insert(_corpus(), _chunks(Chunk, N))
    tdb.build_index()
    q = _queries()
    for db, cls in ((jdb, JChunk), (tdb, Chunk)):
        _mutate_and_rebuild_free(db, cls)
        db.search(q, 5)
    js, ts = jdb.stats(), tdb.stats()
    assert set(js) == set(ts)
    for key in ("live", "slots", "vector_bytes", "index_bytes", "fresh",
                "inserts", "removals", "searches", "rebuilds",
                "fused_searches"):
        assert js[key] == ts[key], key
    assert ts["index_bytes"] > (0 if index_type == "flat" else
                                tdb.centroids.nbytes + tdb.buckets.nbytes)


def _clustered(n, d, n_queries, seed=0):
    """``n`` unit rows around 256 centres (noise 0.6) and queries near
    random rows (noise 0.1), as the chip run's DB phases draw them."""
    rng = np.random.default_rng(seed)

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
            np.float32)

    centres = unit(rng.standard_normal((256, d)))
    rows = unit(centres[rng.integers(0, 256, n)]
                + 0.6 * unit(rng.standard_normal((n, d))))
    q = unit(rows[rng.integers(0, n, n_queries)]
             + 0.1 * rng.standard_normal((n_queries, d)))
    return rows, q


# (config, rows, width, the largest shortfall of the port's recall@16 below
# the reference's). Each package trains its own index from its own draws:
# the port's k-means initial rows come from torch.Generator, the
# reference's from jax.random, so IVF lists and PQ codebooks differ. Across
# five k-means seeds at 65,536 x 384 the reference read 0.977-0.996 and the
# port 0.969-0.988 on IVF64; these rows read 0.9766 (reference) and 0.9531
# (port). SQ8 trains without a draw: equal (0.9756). PQ (8-wide subspaces,
# as PQ48 at width 384) runs at a quarter of the rows with 16 subspaces of
# width 128, for the test's time: 0.4937 and 0.5029.
OWN_BUILD = {
    "ivf": (dict(index_type="ivf", nlist=64, nprobe=4), 65536, 384, 0.03),
    "flat-sq8": (dict(index_type="flat", quant="sq8"), 65536, 384, 0.0),
    "ivf-pq": (dict(index_type="ivf", quant="pq", nlist=32, nprobe=4,
                    pq_m=16), 16384, 128, 0.03),
}


@pytest.mark.parametrize("case", sorted(OWN_BUILD))
def test_own_index_build_recall_near_jax(case):
    """Each package builds its own index on one row set: the port's
    recall@16 against exact search is at most the stated margin below the
    reference's (and at most 0.03 above it)."""
    kw, n, d, margin = OWN_BUILD[case]
    rows, q = _clustered(n, d, 128)
    exact = np.argsort(-(q @ rows.T), axis=1, kind="stable")[:, :16]
    cfg = dict(dim=d, capacity=n, use_hybrid=False, **kw)
    recall = {}
    for name, db in (("jax", JaxVectorDB(JDBConfig(**cfg))),
                     ("port", TorchVectorDB(DBConfig(**cfg), device="cpu"))):
        cls = JChunk if name == "jax" else Chunk
        db.insert(rows, [cls(-1, i // 4, "") for i in range(n)])
        db.build_index()
        ids = np.concatenate([np.stack([r.chunk_ids for r in db.search(
            q[lo:lo + 16], 16)]) for lo in range(0, len(q), 16)])
        recall[name] = np.mean([len(set(a) & set(e)) / 16
                                for a, e in zip(ids, exact)])
    assert recall["jax"] - margin <= recall["port"] <= recall["jax"] + 0.03, \
        recall


# -- the DB's phase spans (repro_torch.obs) ----------------------------------

PHASES = ["db.search", "db.upload_q", "db.snapshot", "db.masks", "db.main",
          "db.masks", "db.fresh", "db.merge", "db.copy_out", "db.results"]


def _fresh_fused_db(index_type, quant):
    """A tiny ``torch_fused`` DB on the CPU: a built index, one removed
    document, and 10 rows in the freshness buffer."""
    db = registry.create("vectordb", "torch_fused", index_type=index_type,
                         quant=quant, dim=DIM, capacity=N + 96, nlist=4,
                         nprobe=2, flat_capacity=48, device="cpu")
    db.insert(_corpus(), _chunks(Chunk, N))
    db.build_index()
    db.remove(2)
    db.insert(_corpus(10, seed=3), _chunks(Chunk, 10, doc0=900))
    return db


@pytest.mark.parametrize("index_type,quant,op", [("ivf", "none", "ivf_topk"),
                                                 ("flat", "sq8", "sq8_topk")])
def test_traced_search_emits_its_phases(index_type, quant, op):
    """With a tracer attached a search records its phases in order, all
    with the call's ``req`` and inside its ``db.search``, each with a self
    time >= 0; with none (and no profiler) nothing is recorded anywhere,
    and the lists are bit-identical to the traced search's."""
    from repro_torch import obs

    db = _fresh_fused_db(index_type, quant)
    q = _queries()
    n_process = len(obs.PROCESS_TRACER.spans())
    plain = db.search(q, 5)
    assert len(obs.PROCESS_TRACER.spans()) == n_process
    db.tracer = obs.Tracer(clock=obs.EpochClock())
    traced = db.search(q, 5)
    for a, b in zip(plain, traced):
        assert np.array_equal(a.chunk_ids, b.chunk_ids)
        assert np.array_equal(a.scores, b.scores)
    sp = sorted(db.tracer.spans(), key=lambda s: (s.t0, -s.t1))
    assert [s.name for s in sp] == PHASES
    call = sp[0]
    assert call.args == {"n": len(q), "k": 5, "fresh": 10} and \
        db.stats()["fresh"] == 10
    assert {s.req for s in sp} == {call.req} and call.req > 0
    assert {s.tid for s in sp} == {"db"}
    assert {s.thread for s in sp} == {threading.get_native_id()}
    for s in sp[1:]:
        assert call.t0 <= s.t0 <= s.t1 <= call.t1
    for a, b in zip(sp[1:], sp[2:]):
        assert a.t1 <= b.t0
    assert [s.args["which"] for s in sp if s.name == "db.masks"] == \
        ["main", "fresh"]
    assert next(s for s in sp if s.name == "db.main").args == {"op": op}
    assert next(s for s in sp if s.name == "db.snapshot").args[
        "wait_ms"] >= 0
    selfs = obs.self_times(sp)
    assert all(t >= 0 for t in selfs)
    assert selfs[0] == pytest.approx(
        call.dur - sum(s.dur for s in sp[1:]), abs=1e-9)


def test_traced_writes_and_the_rebuild_inside_an_insert():
    """``db.insert`` and ``db.remove`` span each write; the insert that
    crosses the buffer's threshold holds its ``db.rebuild``."""
    from repro_torch import obs

    db = TorchVectorDB(DBConfig(dim=DIM, capacity=N + 96, nlist=4, nprobe=2,
                                flat_capacity=48, use_kernel="fused"),
                       device="cpu")
    db.insert(_corpus(), _chunks(Chunk, N))
    db.build_index()
    db.tracer = obs.Tracer(clock=obs.EpochClock())
    db.insert(_corpus(30, seed=9), _chunks(Chunk, 30, doc0=500))
    assert db.remove(500) == 4
    db.insert(_corpus(10, seed=8), _chunks(Chunk, 10, doc0=600))  # 36 >= 36
    assert db.counters["rebuilds"] == 2
    sp = sorted(db.tracer.spans(), key=lambda s: (s.t0, -s.t1))
    assert [(s.name, s.args) for s in sp] == [
        ("db.insert", {"n": 30}), ("db.remove", {"n": 4}),
        ("db.insert", {"n": 10}), ("db.rebuild", {"fresh": 36})]
    ins, rebuild = sp[2], sp[3]
    assert ins.req == rebuild.req and ins.t0 <= rebuild.t0 <= rebuild.t1 \
        <= ins.t1
    assert len({s.req for s in sp}) == 3
