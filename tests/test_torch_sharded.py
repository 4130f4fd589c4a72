"""The port's sharded vector DB against the JAX package's, on the CPU.

Both packages' ``ShardedVectorDB`` take the same seeded numpy rows and the
same insert/remove/update stream. The two packages' k-means draws differ
(``jax.random.choice`` cannot be reproduced in torch), so every k-means run
of the port's shards (each shard's IVF lists, each PQ subspace) starts from
the reference's initial draw on the same rows, injected into
``repro_torch.core.vectordb.kmeans``. Tolerance (the parity rule of
``repro_torch.kernels.parity``): scores within 1e-5 (fp32, another
summation order), ids equal outside groups of near-tied scores. A 1-shard
DB must give a bare ``TorchVectorDB``'s output bit for bit.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core.interfaces import Chunk as JChunk  # noqa: E402
from repro.core.vectordb import merge_topk as jax_merge_topk  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.sharded import ShardedDBConfig as JShardedDBConfig  # noqa: E402
from repro.sharded import ShardedVectorDB as JShardedVectorDB  # noqa: E402
from repro.sharded import doc_shard as jdoc_shard  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core import vectordb as tvdb  # noqa: E402
from repro_torch.core.interfaces import Chunk  # noqa: E402
from repro_torch.core.vectordb import DBConfig, TorchVectorDB  # noqa: E402
from repro_torch.kernels.parity import compare_topk  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.sharded import (ShardedDBConfig, ShardedVectorDB,  # noqa: E402
                                 doc_shard)

torch.backends.cuda.matmul.allow_tf32 = False

DIM = 16
N = 384
K = 8
# (index_type, quant): every search path of a shard
KINDS = [("flat", "none"), ("ivf", "none"), ("flat", "sq8"), ("ivf", "pq")]
CFG = dict(dim=DIM, capacity=1024, nlist=16, nprobe=3, flat_capacity=96)


@pytest.fixture
def reference_kmeans(monkeypatch):
    """Every port k-means run starts from the reference's draw."""
    kmeans = tvdb.kmeans

    def from_reference_init(x, k, iters=10, seed=0, init=None):
        if init is None:
            n = x.shape[0]
            idx = np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                             (k,), replace=n < k))
            init = x[torch.from_numpy(idx).long()]
        return kmeans(x, k, iters, seed, init=init)

    monkeypatch.setattr(tvdb, "kmeans", from_reference_init)


def _corpus(n=N, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    return vecs / np.linalg.norm(vecs, axis=1, keepdims=True)


def _queries(vecs, nq=12, seed=1):
    rng = np.random.default_rng(seed)
    return (vecs[:nq] + 0.02 * rng.standard_normal((nq, DIM))).astype(
        np.float32)


def _chunks(cls, n):
    return [cls(chunk_id=-1, doc_id=i // 4, text=f"c{i}") for i in range(n)]


def _pair(index_type, quant, rung="off", n_shards=4, **kw):
    cfg = dict(CFG, index_type=index_type, quant=quant, **kw)
    jdb = JShardedVectorDB(JShardedDBConfig(n_shards=n_shards, **cfg))
    tdb = ShardedVectorDB(ShardedDBConfig(n_shards=n_shards, use_kernel=rung,
                                          **cfg), device="cpu")
    return jdb, tdb


def _stream(dbs):
    """The same mutation stream into every DB: fresh inserts (into the
    freshness buffers and past a rebuild threshold), removals and updates.
    Returns each DB's chunk objects in insert order."""
    rng = np.random.default_rng(7)
    made = [[] for _ in dbs]
    for step in range(24):
        doc = int(rng.integers(0, N // 4 + 24))
        vecs = _corpus(4, seed=100 + step)
        for db, out in zip(dbs, made):
            cls = JChunk if isinstance(db, JShardedVectorDB) else Chunk
            chunks = [cls(chunk_id=-1, doc_id=doc, text=f"m{step}_{j}")
                      for j in range(4)]
            if step % 3 == 0:
                db.remove(doc)
                continue
            if step % 3 == 1:
                db.update(doc, vecs, chunks)
            else:
                db.insert(vecs, [cls(chunk_id=-1, doc_id=N // 4 + step,
                                     text=c.text) for c in chunks])
                chunks = []
            out.extend(chunks)
    return made


def _results(res):
    return (np.stack([r.scores for r in res]),
            np.stack([r.chunk_ids for r in res]))


def test_doc_shard_matches_jax():
    ids = np.random.default_rng(0).integers(0, 1 << 40, 10_000).tolist()
    ids += list(range(-5, 5)) + [2**32 - 1, 2**32, 2**33 + 7]
    for n in (1, 2, 3, 4, 7, 8, 16):
        assert [doc_shard(d, n) for d in ids] == \
            [jdoc_shard(d, n) for d in ids], n


@pytest.mark.parametrize("n_shards", range(1, 9))
def test_shard_cfg_matches_jax(n_shards):
    for cap, nlist, flat, slack in ((1024, 16, 96, 1.5), (8192, 16, 1024, 1.5),
                                    (1_114_112, 1024, 65_536, 1.5),
                                    (100, 3, 5, 1.0)):
        kw = dict(n_shards=n_shards, dim=DIM, capacity=cap, nlist=nlist,
                  flat_capacity=flat, balance_slack=slack, quant="sq8")
        want = JShardedVectorDB(JShardedDBConfig(**kw))._shard_cfg()
        got = ShardedVectorDB(ShardedDBConfig(**kw), device="meta"
                              )._shard_cfg()
        assert {f: getattr(got, f) for f in vars(got)} == \
            {f: getattr(want, f) for f in vars(want)}


@pytest.mark.parametrize("rung", ["off", "fused"])
@pytest.mark.parametrize("index_type,quant", KINDS)
def test_matches_jax_after_a_mutation_stream(index_type, quant, rung,
                                             reference_kmeans):
    """Initial rows, an index build, then the stream: the same global ids
    on every chunk, the same ``doc_slots``, and the same search results,
    before and after the stream (the port's ``fused`` rung: the kernels'
    plain versions over the packed mirrors)."""
    jdb, tdb = _pair(index_type, quant, rung)
    vecs = _corpus()
    jch, tch = _chunks(JChunk, N), _chunks(Chunk, N)
    jdb.insert(vecs, jch)
    tdb.insert(vecs, tch)
    assert [c.chunk_id for c in tch] == [c.chunk_id for c in jch]
    jdb.build_index()
    tdb.build_index()
    q = _queries(vecs)
    for phase in ("built", "mutated"):
        if phase == "mutated":
            jmade, tmade = _stream([jdb, tdb])
            assert [c.chunk_id for c in tmade] == \
                [c.chunk_id for c in jmade]
        assert dict(tdb.doc_slots.items()) == dict(jdb.doc_slots.items())
        want, got = _results(jdb.search(q, K)), _results(tdb.search(q, K))
        res = compare_topk(*want, *got)
        assert res["violations"] == 0 and res["max_abs_diff"] <= 1e-5, \
            (phase, res)
        assert got[1].dtype == want[1].dtype
        for cid in got[1][got[1] >= 0]:
            j, t = jdb.get_chunk(cid), tdb.get_chunk(cid)
            assert (t.doc_id, t.text, t.chunk_id) == (j.doc_id, j.text,
                                                      j.chunk_id)
    st, jst = tdb.stats(), jdb.stats()
    for key in ("live", "slots", "fresh", "inserts", "removals", "rebuilds",
                "vector_bytes", "index_bytes", "n_shards", "shard_live_min",
                "shard_live_max", "shard_imbalance", "searches",
                "mesh_searches"):
        assert st[key] == jst[key], key
    assert st["rebuilds"] > 4         # a shard's buffer folded in mid-stream


@pytest.mark.parametrize("index_type,quant", KINDS)
def test_carried_state_matches_jax(index_type, quant):
    """``convert.sharded_db_from_jax``: every shard's state, the epoch and
    the counters carried across; the port's own rebuilds after that."""
    jdb, _ = _pair(index_type, quant)
    vecs = _corpus()
    jdb.insert(vecs, _chunks(JChunk, N))
    jdb.build_index()
    _stream([jdb])
    tdb = convert.sharded_db_from_jax(jdb, use_kernel="fused", device="cpu")
    assert tdb.cfg.use_kernel == "fused" and tdb._epoch == jdb._epoch
    assert tdb.counters == jdb.counters
    q = _queries(vecs)
    res = compare_topk(*_results(jdb.search(q, K)),
                       *_results(tdb.search(q, K)))
    assert res["violations"] == 0 and res["max_abs_diff"] <= 1e-5, res


@pytest.mark.parametrize("index_type,quant", KINDS)
def test_one_shard_equals_torch_vector_db_bit_for_bit(index_type, quant):
    """At ``n_shards=1`` every shard setting passes through and global ids
    are local slots: the same state and the same results, bit for bit."""
    cfg = dict(CFG, index_type=index_type, quant=quant, use_kernel="fused")
    one = ShardedVectorDB(ShardedDBConfig(n_shards=1, **cfg), device="cpu")
    bare = TorchVectorDB(DBConfig(**cfg), device="cpu")
    assert one._shard_cfg() == bare.cfg
    vecs = _corpus()
    for db in (one, bare):
        db.insert(vecs, _chunks(Chunk, N))
        db.build_index()
    _stream([one, bare])
    q = _queries(vecs)
    for k in (1, K, 40):
        (s1, i1), (s2, i2) = _results(one.search(q, k)), _results(
            bare.search(q, k))
        assert np.array_equal(i1, i2) and np.array_equal(s1, s2)
    assert dict(one.doc_slots.items()) == bare.doc_slots


@pytest.mark.parametrize("index_type,quant", KINDS)
def test_global_ids_are_disjoint_across_shards(index_type, quant):
    """Shard ``s`` answers only ids in ``[s·cap, (s+1)·cap)``, so no id
    repeats across the lists the search folds, and the port's merge
    (a stable sort) equals the reference's on them (its no-dedup path)."""
    _, tdb = _pair(index_type, quant, "fused")
    vecs = _corpus()
    tdb.insert(vecs, _chunks(Chunk, N))
    tdb.build_index()
    _stream([tdb])
    q = torch.from_numpy(_queries(vecs))
    snaps = tdb.snapshot()
    cap = tdb.shard_capacity
    lists = []
    for sid, (sh, snap) in enumerate(zip(tdb.shards, snaps)):
        s, i = sh.search_arrays(q, K, snap)
        gi = torch.where(i >= 0, i + sid * cap, i)
        valid = gi[gi >= 0]
        assert bool(((valid >= sid * cap) & (valid < (sid + 1) * cap)).all())
        lists.append((s, gi))
    for a in range(len(lists)):
        for b in range(a + 1, len(lists)):
            for ra, rb in zip(lists[a][1], lists[b][1]):
                assert not set(ra[ra >= 0].tolist()) & set(
                    rb[rb >= 0].tolist())
    s, gi = lists[0]
    js, jgi = s.numpy(), gi.numpy()
    for s2, gi2 in lists[1:]:
        s, gi = tvdb.merge_topk(s, gi, s2, gi2, K)
        js, jgi = jax_merge_topk(js, jgi, s2.numpy(), gi2.numpy(), K)
    assert np.array_equal(gi.numpy(), jgi) and np.array_equal(s.numpy(), js)
    got = tdb.search_arrays(q, K, snaps)
    assert torch.equal(got[0], s) and torch.equal(got[1], gi)


def test_tiny_shards_pad_to_k():
    """Shards smaller than k pad with (NEG, -1); the merge masks them."""
    vecs = _corpus(12)
    cfg = dict(n_shards=4, index_type="flat", dim=DIM, capacity=64,
               balance_slack=1.0)
    jdb = JShardedVectorDB(JShardedDBConfig(**cfg))
    tdb = ShardedVectorDB(ShardedDBConfig(**cfg), device="cpu")
    jdb.insert(vecs, _chunks(JChunk, 12))
    tdb.insert(vecs, _chunks(Chunk, 12))
    q = _queries(vecs, nq=3)
    want, got = _results(jdb.search(q, 24)), _results(tdb.search(q, 24))
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert (got[1] == -1).sum() == 3 * 12


def test_set_nprobe_is_atomic_under_concurrent_searches():
    """A ladder walk against searching threads: every search's cross-shard
    snapshot carries one nprobe level, and every shard takes the last."""
    vecs = _corpus(256)
    db = ShardedVectorDB(ShardedDBConfig(
        n_shards=4, index_type="ivf", dim=DIM, capacity=1024, nlist=16,
        nprobe=8, flat_capacity=64), device="cpu")
    db.insert(vecs, _chunks(Chunk, 256))
    db.build_index()
    seen, stop = [], threading.Event()
    merge = db._merge_search

    def recording(q, k, snaps, rung=None):
        seen.append({s["nprobe"] for s in snaps})
        return merge(q, k, snaps, rung)

    db._merge_search = recording

    def walker():
        i = 0
        while not stop.is_set():
            db.set_nprobe([8, 4, 2, 1][i % 4])
            i += 1

    def searcher():
        q = _queries(vecs, nq=2)
        while not stop.is_set():
            db.search(q, 4)

    ts = [threading.Thread(target=walker)] + [
        threading.Thread(target=searcher) for _ in range(2)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 30.0     # a loaded machine searches slowly
    while len(seen) < 40 and time.monotonic() < deadline:
        time.sleep(0.05)
    stop.set()
    for t in ts:
        t.join()
    assert len(seen) >= 40 and all(len(s) == 1 for s in seen), seen[:5]
    assert len({s.pop() for s in seen}) > 1       # the walk was observed
    db.set_nprobe(2)
    assert db.cfg.nprobe == 2 and all(sh.cfg.nprobe == 2 for sh in db.shards)


def test_stats_gauges_and_spans_match_jax():
    """``stats()`` and ``shard_stats()`` after inserts and searches, the
    gauges, and the tracer's ``db.*`` spans with the reference's args."""
    jdb, tdb = _pair("flat", "none")
    jtr, ttr = JTracer(), Tracer()
    jdb.tracer, tdb.tracer = jtr, ttr
    vecs = _corpus()
    jdb.insert(vecs, _chunks(JChunk, N))
    tdb.insert(vecs, _chunks(Chunk, N))
    q = _queries(vecs)
    for db in (jdb, tdb):
        db.search(q, K)
        db.search(q[:3], 2)
    skip = ("insert_time_s", "build_time_s", "search_time_s", "merge_time_s")
    st, jst = tdb.stats(), jdb.stats()
    assert set(st) == set(jst)
    assert {k: v for k, v in st.items() if k not in skip} == \
        {k: v for k, v in jst.items() if k not in skip}
    assert st["searches"] == 15 and st["merge_time_s"] > 0
    assert [{k: v for k, v in r.items() if k not in skip}
            for r in tdb.shard_stats()] == \
        [{k: v for k, v in r.items() if k not in skip}
         for r in jdb.shard_stats()]
    assert {k: g() for k, g in tdb.gauges().items()} == \
        {k: g() for k, g in jdb.gauges().items()}

    def spans(tr):
        return [(s.name, s.cat, s.tid, dict(s.args)) for s in tr.spans()]

    assert spans(ttr) == spans(jtr)
    assert [s[0] for s in spans(ttr)][:6] == ["db.shard_scan"] * 4 + [
        "db.merge", "db.search"]


def test_shard_phases_land_inside_their_shard_scans_under_a_profiler():
    """With no tracer of its own, the sharded DB and its shards record on
    the process tracer while a torch profiler runs: each ``db.shard_scan``
    holds its shard's ``db.masks`` and ``db.main`` phases."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    _, tdb = _pair("ivf", "none", n_shards=2)
    vecs = _corpus()
    tdb.insert(vecs, _chunks(Chunk, N))
    n0 = len(obs.PROCESS_TRACER.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        tdb.search(_queries(vecs), K)
    sp = obs.PROCESS_TRACER.spans()[n0:]
    scans = [s for s in sp if s.name == "db.shard_scan"]
    assert [s.args["shard"] for s in scans] == [0, 1]
    assert [s.name for s in sp][-2:] == ["db.merge", "db.search"]
    for scan in scans:
        inside = [s.name for s in sp if s.thread == scan.thread
                  and scan.t0 <= s.t0 and s.t1 <= scan.t1
                  and s is not scan]
        assert {"db.masks", "db.main"} <= set(inside), inside


def test_registered_as_torch_sharded_on_the_device_given():
    db = registry.create("vectordb", "torch_sharded", n_shards=2,
                         index_type="flat", dim=DIM, capacity=256,
                         device="cpu")
    assert isinstance(db, ShardedVectorDB) and db.cfg.n_shards == 2
    assert all(sh.device.type == "cpu" for sh in db.shards)
    with pytest.raises(ValueError, match="use_kernel"):
        ShardedVectorDB(ShardedDBConfig(use_kernel="bogus"), device="cpu")


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("index_type,quant", KINDS)
def test_sharded_db_on_the_card_matches_the_cpu(index_type, quant):
    """One carried state, fused on the card and ``off`` on the CPU: the
    same results by the parity rule, through each shard's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops

    jdb, _ = _pair(index_type, quant)
    vecs = _corpus()
    jdb.insert(vecs, _chunks(JChunk, N))
    jdb.build_index()
    _stream([jdb])
    cpu = convert.sharded_db_from_jax(jdb, use_kernel="off", device="cpu")
    card = convert.sharded_db_from_jax(jdb, use_kernel="fused",
                                       device="cuda")
    q = _queries(vecs)
    ops.reset_launch_counts()
    got = _results(card.search(q, K))
    launches = ops.launch_counts()
    res = compare_topk(*_results(cpu.search(q, K)), *got)
    assert res["violations"] == 0 and res["max_abs_diff"] <= 1e-5, res
    main = {("flat", "none"): "topk_search", ("ivf", "none"): "ivf_topk",
            ("flat", "sq8"): "sq8_topk", ("ivf", "pq"): "pq_topk"}
    assert launches[main[(index_type, quant)]] >= 1, launches
