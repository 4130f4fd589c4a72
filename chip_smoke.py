#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure:

1. the card: ``nvidia-smi`` name and power limit, the torch version;
2. build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc, one
   process per source, all at once;
3. kernels against their plain versions, on the card, at the edge-case
   shapes and at the deployment shapes (64 queries; 1,048,576 x 384 fp32
   rows; IVF with 1024 lists of 4096 slots, nprobe 16; k 16), with the
   median time of the kernel's wrapper, its plain version and one PyTorch
   yardstick over 20 runs (CUDA events), and its bound on this card;
4. the vector DB at deployment size (``TorchVectorDB``, ``torch_fused``
   rung): 1,048,576 clustered unit rows, IVF build, 32,768 fresh rows in the
   freshness buffer, 1% of the documents removed, 20 batches of 64 queries.
   The results must equal the plain ``off`` rung on the same state; the
   launch counts of this run show it went through both kernels;
5. serve: ``repro_torch.launch.serve`` on ``src/repro_torch/specs/fused_ivf.json``
   must answer its requests through both kernels with a quality report.

The last lines are one JSON object on the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a card, or run
outside a checkout, it exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TOL = 1e-5                 # |score| tolerance: unit vectors, fp32
RUNS = 20                  # timed runs per measurement (median reported)

NQ, N, DIM, K = 64, 1 << 20, 384, 16
NLIST, CAP_B, NPROBE = 1024, 4096, 16
DB_CAPACITY, FLAT_CAPACITY, N_FRESH = 1_114_112, 65_536, 32_768
DEVICE = "cuda"


def say(*parts) -> None:
    print(*parts, flush=True)


def median_ms(fn, torch) -> float:
    """Median over RUNS of one call of ``fn`` timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound(n_bytes: float, n_flop: float):
    """Least time on this card: the larger of bytes over the memory rate
    and fp32 FMA work over the fp32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(name, got, what) -> dict:
    if got["violations"] or got["max_abs_diff"] > TOL:
        raise AssertionError(f"{name} disagrees with {what}: {got}")
    return got


def check_ties(torch, name, want, got) -> None:
    """On exact scores with repeated rows, ids and scores must equal the
    plain version's: equal scores keep the lower row first, as
    ``lax.top_k`` does."""
    if not (torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])):
        raise AssertionError(f"{name}: tie order differs from the plain "
                             f"version")
    say(f"{name}: ids equal the plain version's, tie order included")


def phase_kernels(torch, ops, ref, compare_topk):
    """Every kernel against its plain version; returns the kernel records."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(n, d):
        return torch.nn.functional.normalize(
            torch.randn(n, d, generator=gen, device=dev), dim=1)

    def live_mask(n, p):
        return torch.rand(n, generator=gen, device=dev) < p

    records = {}
    def grid(n, d):
        """Entries in {-0.5, ..., 0.5} by 0.25: every dot product is exact
        in fp32 in any summation order, so equal scores are real ties."""
        return torch.randint(-2, 3, (n, d), generator=gen,
                             device=dev).float() / 4

    # -- topk_search: tie order on rows repeated across sub-tiles and tiles
    base = grid(1000, 32)
    v = torch.cat([base, base, base.flip(0)])
    for k in (7, 128):
        q, live = grid(6, 32), live_mask(3000, 0.9)
        check_ties(torch, f"topk_search ties k={k}",
                   ref.topk_search(q, v, live, k),
                   ops.topk_search(q, v, live, k))
    # -- topk_search: edge cases, then the deployment shapes
    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}
    for nq, n, d, k, p in [(3, 32, 8, 8, 1.0), (2, 64, 8, 6, 0.05),
                           (1, 5, 8, 8, 1.0), (1, 129, 24, 4, 0.0),
                           (7, 1000, 64, 5, 0.8), (5, 4101, 48, 16, 0.8),
                           (70, 3000, 32, 128, 0.9),
                           (NQ, N, DIM, K, 0.99)]:
        q, v, live = unit(nq, d), unit(n, d), live_mask(n, p)
        got = check(f"topk_search nq={nq} N={n} d={d} k={k}",
                    compare_topk(*ref.topk_search(q, v, live, k),
                                 *ops.topk_search(q, v, live, k)), "plain")
        say(f"topk_search nq={nq} N={n} d={d} k={k} live={p}: max|dscore| "
            f"{got['max_abs_diff']:.3g}, id mismatches {got['id_mismatches']}")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], got["max_abs_diff"])
        worst["id_mismatches"] += got["id_mismatches"]
    n_live = int(live.sum())
    neg = torch.tensor(ref.NEG, device=dev)
    t = {"ms": median_ms(lambda: ops.topk_search(q, v, live, K), torch),
         "plain_ms": median_ms(lambda: ref.topk_search(q, v, live, K), torch),
         "library_ms": median_ms(lambda: torch.topk(
             torch.where(live[None, :], q @ v.T, neg), K), torch)}
    bms, by = bound(n_live * DIM * 4 + N + NQ * DIM * 4 + NQ * K * 8,
                    2.0 * NQ * n_live * DIM)
    records["topk_search"] = dict(
        name="topk_search", route="cuda",
        source="src/repro_torch/csrc/topk_search.cu",
        replaces="src/repro/kernels/topk_search.py:73",
        jax="src/repro/kernels/topk_search.py:topk_search_pallas",
        max_abs_err=worst["max_abs_diff"], id_mismatches=worst["id_mismatches"],
        bound_ms=bms, bound_by=by, **t)
    say(f"topk_search at nq={NQ} N={N} d={DIM} k={K} ({n_live} live): "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.topk "
        f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
    del q, v, live

    # -- ivf_topk: edge cases, then the deployment shapes
    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}

    def packed(nlist, cap_b, d, fill_lo, fill_hi):
        """Clustered buckets filled from the front, 1% tombstones."""
        cent = unit(nlist, d)
        fill = torch.randint(fill_lo, fill_hi + 1, (nlist,), generator=gen,
                             device=dev)
        pos = torch.arange(cap_b, device=dev)
        member = (pos[None, :] < fill[:, None]).reshape(-1)
        ok = member & live_mask(nlist * cap_b, 0.99)
        vecs = torch.nn.functional.normalize(
            cent.repeat_interleave(cap_b, 0)
            + 0.6 * unit(nlist * cap_b, d), dim=1)
        slot = torch.where(member, torch.randperm(
            nlist * cap_b, generator=gen, device=dev).int(), -1).int()
        return cent, vecs, slot, ok

    # tie order: every even packed row repeated in the next one
    for nq, nlist, cap_b, d, nprobe, k in [(5, 4, 24, 16, 3, 6),
                                           (9, 16, 256, 64, 5, 128)]:
        cent, pv, slot, ok = packed(nlist, cap_b, d, 0, cap_b)
        pv = grid(nlist * cap_b, d)
        pv[1::2] = pv[0::2]
        q = grid(nq, d)
        args = (q, cent, pv, slot, ok, nprobe, k)
        check_ties(torch, f"ivf_topk ties nq={nq} cap_b={cap_b} k={k}",
                   ref.ivf_topk(*args), ops.ivf_topk(*args))

    for nq, nlist, cap_b, d, nprobe, k, lo, hi in [
            (3, 4, 64, 16, 2, 8, 8, 40), (1, 4, 16, 8, 4, 32, 0, 16),
            (5, 8, 100, 24, 3, 5, 0, 0), (9, 16, 256, 64, 5, 128, 50, 256),
            (NQ, NLIST, CAP_B, DIM, NPROBE, K, 512, 1536)]:
        cent, pv, slot, ok = packed(nlist, cap_b, d, lo, hi)
        q = torch.nn.functional.normalize(
            cent[torch.randint(nlist, (nq,), generator=gen, device=dev)]
            + 0.5 * unit(nq, d), dim=1)
        args = (q, cent, pv, slot, ok, nprobe, k)
        got = check(f"ivf_topk nq={nq} nlist={nlist} cap_b={cap_b}",
                    compare_topk(*ref.ivf_topk(*args), *ops.ivf_topk(*args)),
                    "plain")
        say(f"ivf_topk nq={nq} nlist={nlist} cap_b={cap_b} d={d} "
            f"nprobe={nprobe} k={k}: max|dscore| {got['max_abs_diff']:.3g}, "
            f"id mismatches {got['id_mismatches']}")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], got["max_abs_diff"])
        worst["id_mismatches"] += got["id_mismatches"]
    pv3, ok2 = pv.view(NLIST, CAP_B, DIM), ok.view(NLIST, CAP_B)

    def library():
        probe = torch.topk(q @ cent.T, NPROBE).indices
        s = torch.bmm(pv3[probe].view(NQ, NPROBE * CAP_B, DIM),
                      q[:, :, None])[:, :, 0]
        return torch.topk(torch.where(ok2[probe].view(NQ, -1), s, neg), K)

    t = {"ms": median_ms(lambda: ops.ivf_topk(*args), torch),
         "plain_ms": median_ms(lambda: ref.ivf_topk(*args), torch),
         "library_ms": median_ms(library, torch)}
    # bytes: every probed bucket's ok bytes and its ok rows once, the slot
    # ids of the rows a (query, probe) emits (its top k, fewer where the
    # bucket holds fewer ok rows), the query block, the centroids, the
    # outputs; FLOP: one dot product per (query, probed ok row) plus the
    # probe's centroid scores
    probe = ref.probe(q, cent, NPROBE).long()
    ok_rows = ok2.sum(1)
    buckets = torch.unique(probe)
    n_bytes = (int(ok_rows[buckets].sum()) * DIM * 4 + len(buckets) * CAP_B
               + int(ok_rows[probe].clamp(max=K).sum()) * 4
               + NQ * DIM * 4 + NLIST * DIM * 4 + NQ * K * 8)
    n_flop = 2.0 * DIM * (int(ok_rows[probe].sum()) + NQ * NLIST)
    bms, by = bound(n_bytes, n_flop)
    records["ivf_topk"] = dict(
        name="ivf_topk", route="cuda", source="src/repro_torch/csrc/ivf_topk.cu",
        replaces="src/repro/kernels/fused_retrieve.py:264",
        jax="src/repro/kernels/fused_retrieve.py:ivf_topk_pallas",
        max_abs_err=worst["max_abs_diff"], id_mismatches=worst["id_mismatches"],
        bound_ms=bms, bound_by=by, **t)
    say(f"ivf_topk at nq={NQ} nlist={NLIST} cap_b={CAP_B} d={DIM} "
        f"nprobe={NPROBE} k={K} ({len(buckets)} buckets probed): kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, gather+bmm+topk "
        f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
    return records


def phase_db(torch, ops, ref, compare_topk):
    """The vector DB at deployment size; returns the launch counts of its
    searches."""
    import numpy as np

    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    centers = torch.nn.functional.normalize(
        torch.randn(4096, DIM, generator=gen, device=dev), dim=1)

    def clustered(n):
        pick = torch.randint(4096, (n,), generator=gen, device=dev)
        noise = torch.nn.functional.normalize(
            torch.randn(n, DIM, generator=gen, device=dev), dim=1)
        return torch.nn.functional.normalize(centers[pick] + 0.6 * noise,
                                             dim=1)

    torch.cuda.reset_peak_memory_stats()
    db = TorchVectorDB(DBConfig(
        index_type="ivf", dim=DIM, capacity=DB_CAPACITY, nlist=NLIST,
        nprobe=NPROBE, flat_capacity=FLAT_CAPACITY, bucket_cap=CAP_B,
        use_kernel="fused"), device=DEVICE)
    t0 = time.perf_counter()
    step = min(1 << 17, N)
    for lo in range(0, N, step):
        db.insert(clustered(step), [Chunk(-1, (lo + i) // 4, "")
                                    for i in range(step)])
    t1 = time.perf_counter()
    db.build_index()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    db.insert(clustered(N_FRESH), [Chunk(-1, (N + i) // 4, "")
                                   for i in range(N_FRESH)])
    n_docs = (N + N_FRESH) // 4
    gone = torch.randperm(n_docs, generator=torch.Generator().manual_seed(2))
    removed = sum(db.remove(int(d)) for d in gone[:n_docs // 100])
    st = db.stats()
    say(f"db: inserted {N} rows in {t1 - t0:.1f} s, build_index "
        f"{t2 - t1:.1f} s (max bucket fill "
        f"{int(db.bucket_live.sum(1).max())} of {CAP_B}), {N_FRESH} fresh "
        f"rows, {removed} rows of {n_docs // 100} docs removed; live "
        f"{int(st['live'])}, fresh {int(st['fresh'])}, rebuilds "
        f"{int(st['rebuilds'])}")
    if st["rebuilds"] != 1 or st["fresh"] == 0:
        raise AssertionError("the freshness buffer was folded in: no scan")

    live_rows = torch.from_numpy(db.live).to(dev)
    picks = torch.nonzero(live_rows)[:, 0]
    batches = []
    for _ in range(20):
        rows = picks[torch.randint(len(picks), (NQ,), generator=gen,
                                   device=dev)]
        batches.append(torch.nn.functional.normalize(
            db.vectors[rows] + 0.1 * torch.randn(NQ, DIM, generator=gen,
                                                 device=dev), dim=1))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [db.search(q.cpu().numpy(), K) for q in batches]
    ms_per_batch = 1e3 * (time.perf_counter() - t0) / len(batches)
    launches = ops.launch_counts()
    say(f"db: 20 batches of {NQ} queries at k={K}: {ms_per_batch:.3f} ms per "
        f"batch (host clock, search() entry to numpy results); launches "
        f"{launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the DB search never launched {name}")

    worst, hits = 0.0, 0
    for q, res in zip(batches, results):
        ids = torch.from_numpy(np.stack([r.chunk_ids for r in res])).to(dev)
        scores = torch.from_numpy(np.stack([r.scores for r in res])).to(dev)
        for lo in range(0, NQ, 8):       # the off rung gathers per query
            s_off, i_off = db.search_arrays(q[lo:lo + 8], K, rung="off")
            got = check("db fused rung", compare_topk(
                s_off, i_off, scores[lo:lo + 8], ids[lo:lo + 8]), "off rung")
            worst = max(worst, got["max_abs_diff"])
        _, exact = ref.topk_search(q, db.vectors, live_rows, K)
        hits += sum(len(set(a.tolist()) & set(b.tolist()))
                    for a, b in zip(ids, exact))
    recall = hits / (len(batches) * NQ * K)
    say(f"db: fused rung equals the off rung (max|dscore| {worst:.3g}); "
        f"recall@{K} against exact search {recall:.4f}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")

    # where a search's time goes: each kernel alone at the DB's shapes,
    # the device-side search, the whole search() call (CUDA events)
    q = batches[0]
    main_live = torch.from_numpy(db.live & db.indexed).to(dev)
    fresh = torch.from_numpy(db.live & ~db.indexed).to(dev)
    slot = db.packed["slot"]
    ok = (slot >= 0) & main_live[slot.clamp(min=0)]
    q_np = q.cpu().numpy()
    parts = {
        "ivf_topk": median_ms(lambda: ops.ivf_topk(
            q, db.centroids, db.packed["vecs"], slot, ok, NPROBE, K), torch),
        "freshness topk_search": median_ms(
            lambda: ops.topk_search(q, db.vectors, fresh, K), torch),
        "search_arrays": median_ms(lambda: db.search_arrays(q, K), torch),
        "search": median_ms(lambda: db.search(q_np, K), torch)}
    say("db: per batch of 64 queries (ms, median of 20): "
        + ", ".join(f"{name} {t:.4f}" for name, t in parts.items()))
    return launches


def phase_serve(torch, ops):
    from repro_torch.launch import serve

    ops.reset_launch_counts()
    doc = serve.main(["--config", str(SRC / "repro_torch" / "specs" /
                                      "fused_ivf.json"),
                      "--mode", "sync", "--docs", "256", "--requests", "64",
                      "--device", DEVICE])
    launches = ops.launch_counts()
    say(f"serve: launches {launches}")
    if not doc["quality"] or min(launches.values()) == 0:
        raise AssertionError(f"serve did not run both kernels with a quality "
                             f"report: {launches} {doc['quality']}")
    return launches


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py runs from the root of a checkout "
                         "(src/repro_torch not found)")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    say(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda})")

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.parity import compare_topk

    t0 = time.perf_counter()
    reports = _build.build_all()
    say(f"build: {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    records = phase_kernels(torch, ops, ref, compare_topk)
    torch.cuda.empty_cache()
    db_launches = phase_db(torch, ops, ref, compare_topk)
    torch.cuda.empty_cache()
    phase_serve(torch, ops)

    kernels = []
    for name, rec in records.items():
        rec["launches"] = db_launches[name]
        kernels.append(rec)
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
