#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure and prints its wall seconds:

1. the card: ``nvidia-smi`` name and power limit, the torch version;
2. build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc, one
   process per source, all at once; each library's registers, spills and
   shared memory per block;
3. kernels against their plain versions, on the card: tie order on
   exact-arithmetic inputs (ids and scores equal; for topk_search also
   across the several tiles one block folds into one list), the edge-case
   shapes and
   the deployment shapes (64 queries; 1,048,576 x 384 fp32 rows or int8
   codes; IVF with 1024 lists of 4096 slots, nprobe 16, PQ with 48
   subspaces; k 16), with the time of the kernel's wrapper, its plain
   version and one PyTorch yardstick (CUDA events, medians of 20: around
   10 back-to-back calls and around single calls), the kernel's ratio to
   the yardstick under both and its share of its bound on this card. topk_search and ivf_topk, then
   quant_score, sq8_topk and pq_topk;
4. the vector DB at deployment size (``TorchVectorDB``), three
   configurations built one after the other from one seeded row set:
   1,048,576 clustered unit rows, the index build, 32,768 fresh rows in the
   freshness buffer, 1% of the documents removed, 20 batches of 64 queries:
   IVF1024 (``fused`` rung: ivf_topk + topk_search), flat + SQ8 (``fused``
   rung: sq8_topk + topk_search; ``op`` rung: quant_score + topk_search)
   and IVF1024 + PQ48 (``fused`` rung: pq_topk + topk_search). Every rung's
   results must equal the plain ``off`` rung on the same state; the launch
   counts of each rung's run show it went through its kernels;
5. serve: ``repro_torch.launch.serve`` on each vector-DB spec of
   ``src/repro_torch/specs`` must answer its requests through its kernels
   with a quality report;
6. flash_attention against its plain version: the reference's test shapes,
   edge shapes (S 1, 63, 65, 192; GQA groups of 1, 3, 4; causal or not;
   bf16 and fp32), the exact first causal row, and the three deployment
   shapes (the Llama-3-8B prefill at S 512 and a ragged 500, the
   embedder, the cross-encoder), each also held to a worst-row relative
   error that a planted fault (one K/V tile dropped) exceeds, with the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   times and the bound;
7. the model at smoke size: one set of seeded weights on the card and on
   the CPU (the llama3 smoke config in fp32, then in bf16 through the bf16
   mma kernel); prefill logits and 8 greedy tokens must agree;
8. the model at full width: Llama-3-8B (8,030,261,248 parameters) built on
   the card from a seed, then ``repro_torch.launch.serve`` with
   ``model_llama3_8b.json`` (transformer embedder, fused IVF DB,
   cross-encoder, ModelLLM), which must answer every request with
   ``flash_attention`` launched once per layer of every prefill, embedder
   and cross-encoder batch.

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
BF16_FLOP_PER_S = 989e12   # tensor cores, dense
TOL = 1e-5                 # |score| tolerance: unit vectors, fp32
# attention output tolerance (rtol and atol, as the reference's kernel test
# states them): bf16 rounds the probabilities and the output; fp32 sums in
# another order
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-3}
# at the bf16 deployment shapes, the worst query row's relative error
# ||got - want|| / ||want|| over its head dim, which the elementwise rule
# cannot bound where |o| is small (late causal rows). The plain version
# rounds the logits to bf16, the kernel does not: exact attention rounded
# once to bf16 reads 0.012-0.014 against the plain version at these shapes
# (on a CPU). The limit lies above that and far below a planted fault's
# reading (one K/V tile dropped, dropped_tile_attention), which the run
# prints beside the kernel's
ATTN_ROW_REL_LIMIT = 3e-2
# prefill logits of the smoke model, card against CPU: fp32 sums in another
# order; bf16 as tests/test_torch_models.py states it (eight ulps at the
# logits' magnitude of 2-4)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
LLAMA3_8B_PARAMS = 8_030_261_248
ENCODER_LAYERS = 4         # the transformer embedder's and cross-encoder's
RUNS = 20                  # timed runs per measurement (median reported)
REPEAT = 10                # back-to-back calls per timed run of a kernel

NQ, N, DIM, K = 64, 1 << 20, 384, 16
NLIST, CAP_B, NPROBE = 1024, 4096, 16
PQ_M = 48                  # FAISS IVF1024,PQ48: 48 sub-quantizers of 8 bits
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


def kernel_ms(fn, torch) -> float:
    """A kernel's (or its plain version's, or a library call's) time: the
    median over RUNS of REPEAT back-to-back calls of ``fn`` between two CUDA
    events, over REPEAT. Back to back, the card does not wait for the host
    between calls, so this reads the device time of a call wherever that
    exceeds the host's time to launch it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEAT):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / REPEAT)
    return sorted(times)[len(times) // 2]


def timings(torch, kernel, plain, library) -> dict:
    """A kernel's wrapper, its plain version and its library call, each
    timed two ways: back to back (``ms``, ``plain_ms``, ``library_ms``:
    ``kernel_ms``, the device's time per call) and one call at a time
    (``call_ms``, ``plain_call_ms``, ``library_call_ms``: ``median_ms``,
    which also holds the host's time to launch a call)."""
    return {"ms": kernel_ms(kernel, torch),
            "plain_ms": kernel_ms(plain, torch),
            "library_ms": kernel_ms(library, torch),
            "call_ms": median_ms(kernel, torch),
            "plain_call_ms": median_ms(plain, torch),
            "library_call_ms": median_ms(library, torch)}


def speed(t: dict, bound_ms: float) -> str:
    """The kernel's time against its library call and its bound, back to
    back, then the single calls' times and ratio."""
    return (f"{t['ms'] / t['library_ms']:.3f}x the library call, "
            f"{100 * bound_ms / t['ms']:.1f} % of the bound; single calls: "
            f"kernel {t['call_ms']:.4f} ms, library {t['library_call_ms']:.4f}"
            f" ms, {t['call_ms'] / t['library_call_ms']:.3f}x")


def bound(n_bytes: float, n_flop: float, peak: float = FP32_FLOP_PER_S):
    """Least time on this card: the larger of bytes over the memory rate
    and the operations over their type's peak (fp32 FMA by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(name, got, what) -> dict:
    if got["violations"] or got["max_abs_diff"] > TOL:
        raise AssertionError(f"{name} disagrees with {what}: {got}")
    return got


def errors(worst) -> dict:
    """The record's error keys: ``max_abs_diff`` (the name of the parity
    rule) and ``max_abs_err`` (the same number under the name the smoke
    line's readers take), plus the id mismatches."""
    return dict(max_abs_diff=worst["max_abs_diff"],
                max_abs_err=worst["max_abs_diff"],
                id_mismatches=worst["id_mismatches"])


def check_ties(torch, name, want, got) -> None:
    """On exact scores with repeated rows, ids and scores must equal the
    plain version's: equal scores keep the lower row first, as
    ``lax.top_k`` does."""
    if not (torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])):
        raise AssertionError(f"{name}: tie order differs from the plain "
                             f"version")
    say(f"{name}: ids equal the plain version's, tie order included")


def draws(torch, seed):
    """Seeded input makers on the card: the generator, unit rows, live
    masks, and grid rows, whose entries in {-0.5, ..., 0.5} by 0.25 make
    every dot product exact in fp32 in any summation order, so equal
    scores are real ties."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def unit(n, d):
        return torch.nn.functional.normalize(
            torch.randn(n, d, generator=gen, device=dev), dim=1)

    def live_mask(n, p):
        return torch.rand(n, generator=gen, device=dev) < p

    def grid(n, d):
        return torch.randint(-2, 3, (n, d), generator=gen,
                             device=dev).float() / 4

    return gen, unit, live_mask, grid


def phase_kernels(torch, ops, ref, compare_topk):
    """Every kernel against its plain version; returns the kernel records."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import topk_search as tts

    dev = torch.device(DEVICE)
    gen, unit, live_mask, grid = draws(torch, 0)
    records = {}

    # -- topk_search: tie order on rows repeated across sub-tiles and tiles
    base = grid(1000, 32)
    v = torch.cat([base, base, base.flip(0)])
    for k in (7, 128):
        q, live = grid(6, 32), live_mask(3000, 0.9)
        check_ties(torch, f"topk_search ties k={k}",
                   ref.topk_search(q, v, live, k),
                   ops.topk_search(q, v, live, k))
    # ... and across the tiles one block folds into one list: the wrapper's
    # G blocks (block b takes tiles b, b + G, ...) over 3G + 1 tiles of
    # grid rows, each query's best row (0.5 sign(q), the highest score a
    # grid row reaches) planted live in tiles G/2, G/2 + G and G/2 + 2G
    tile = _build.tile_rows("topk_search")
    g = tts.BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    n, nq, b = 3 * g * tile + 77, 70, g // 2
    v, q, live = grid(n, 32), grid(nq, 32), live_mask(n, 0.9)
    j = torch.arange(nq, device=dev)
    planted = torch.stack([b * tile + j, (b + g) * tile + 50 + j.flip(0),
                           (b + 2 * g) * tile + 10 + j], 1)
    for col in range(3):
        v[planted[:, col]] = torch.sign(q) / 2
    live[planted] = True
    for k in (1, 16, 128):
        got = ops.topk_search(q, v, live, k)
        check_ties(torch, f"topk_search ties across a block's tiles (N={n}, "
                   f"{g} lists) k={k}", ref.topk_search(q, v, live, k), got)
        if not torch.equal(got[1][:, :3], planted[:, :k].int()):
            raise AssertionError(f"topk_search k={k}: the planted best rows "
                                 f"do not lead")
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
    t = timings(torch, lambda: ops.topk_search(q, v, live, K),
                lambda: ref.topk_search(q, v, live, K),
                lambda: torch.topk(torch.where(live[None, :], q @ v.T, neg),
                                   K))
    bms, by = bound(n_live * DIM * 4 + N + NQ * DIM * 4 + NQ * K * 8,
                    2.0 * NQ * n_live * DIM)
    records["topk_search"] = dict(
        name="topk_search", route="cuda",
        source="src/repro_torch/csrc/topk_search.cu",
        replaces="src/repro/kernels/topk_search.py:73",
        jax="src/repro/kernels/topk_search.py:topk_search_pallas",
        **errors(worst),
        bound_ms=bms, bound_by=by, **t)
    say(f"topk_search at nq={NQ} N={N} d={DIM} k={K} ({n_live} live): "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.topk "
        f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"{speed(t, bms)}")
    # where the kernel's time goes (its C entry point alone, no merge): all
    # 64 queries; 8 queries (the same corpus reads, an eighth of the FMAs
    # and selection); k=1 (the same FMAs, about a tenth of the inserts)
    lib, fn = _build.entry("topk_search", 5, 5)
    n_lists = min(-(-N // _build.tile_rows("topk_search")),
                  tts.BLOCKS_PER_SM * torch.cuda.get_device_properties(
                      dev).multi_processor_count)

    def alone(nq, k):
        qq = q[:nq].contiguous()
        out_s = torch.empty((nq, n_lists, k), device=dev)
        out_i = torch.empty((nq, n_lists, k), dtype=torch.int32, device=dev)
        launch = (qq.data_ptr(), v.data_ptr(),
                  live.view(torch.uint8).data_ptr(), out_s.data_ptr(),
                  out_i.data_ptr(), nq, N, DIM, k, n_lists,
                  torch.cuda.current_stream().cuda_stream)
        _build.check(lib, "topk_search", fn(*launch))
        return kernel_ms(lambda: fn(*launch), torch)

    t["kernel_only_ms"] = alone(NQ, K)
    t["kernel_only_8_queries_ms"] = alone(8, K)
    t["kernel_only_k1_ms"] = alone(NQ, 1)
    say(f"topk_search kernel alone: {t['kernel_only_ms']:.4f} ms; with 8 "
        f"queries {t['kernel_only_8_queries_ms']:.4f} ms; with k=1 "
        f"{t['kernel_only_k1_ms']:.4f} ms")
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

    t = timings(torch, lambda: ops.ivf_topk(*args),
                lambda: ref.ivf_topk(*args), library)
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
        **errors(worst),
        bound_ms=bms, bound_by=by, **t)
    say(f"ivf_topk at nq={NQ} nlist={NLIST} cap_b={CAP_B} d={DIM} "
        f"nprobe={NPROBE} k={K} ({len(buckets)} buckets probed): kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, gather+bmm+topk "
        f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"{speed(t, bms)}")
    return records


def phase_quant_kernels(torch, ops, ref, compare_topk):
    """quant_score, sq8_topk and pq_topk against their plain versions;
    returns the kernel records."""
    dev = torch.device(DEVICE)
    gen, unit, live_mask, grid = draws(torch, 3)

    def sq8(n, d):
        """Codes and scale of unit rows, as ``_train_sq`` makes them."""
        x = unit(n, d)
        scale = x.abs().amax(0) / 127.0 + 1e-12
        return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale

    records = {}
    neg = torch.tensor(ref.NEG, device=dev)

    # -- quant_score and sq8_topk: tie order on exact scores. Small integer
    # codes, a scale of 0.5 and query entries by 0.25: every dot product is
    # exact in fp32, every code row appears three times across sub-tiles
    # and corpus tiles
    base = torch.randint(-3, 4, (1000, 32), generator=gen,
                         device=dev).to(torch.int8)
    codes = torch.cat([base, base, base.flip(0)])
    scale = torch.full((32,), 0.5, device=dev)
    for k in (7, 128):
        q, live = grid(6, 32), live_mask(3000, 0.9)
        check_ties(torch, f"sq8_topk ties k={k}",
                   ref.sq8_topk(q, codes, scale, live, k),
                   ops.sq8_topk(q, codes, scale, live, k))
    if not torch.equal(ops.quant_score(q, codes, scale),
                       ref.quant_score(q, codes, scale)):
        raise AssertionError("quant_score: exact scores differ from the "
                             "plain version's")
    say("quant_score ties: scores equal the plain version's")

    # -- quant_score: edge cases, then the deployment shapes (every element)
    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}
    for nq, n, d in [(3, 100, 32), (1, 5, 8), (65, 1025, 24),
                     (70, 3000, 48), (NQ, N, DIM)]:
        q = unit(nq, d)
        codes, scale = sq8(n, d)
        got, want = ops.quant_score(q, codes, scale), ref.quant_score(
            q, codes, scale)
        diff = float((got - want).abs().max())
        say(f"quant_score nq={nq} N={n} d={d}: max|dscore| {diff:.3g}")
        if not diff <= TOL or got.shape != want.shape:
            raise AssertionError(f"quant_score nq={nq} N={n} d={d} "
                                 f"disagrees with plain: {diff}")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], diff)
        del got, want
    t = timings(torch, lambda: ops.quant_score(q, codes, scale),
                lambda: ref.quant_score(q, codes, scale),
                lambda: (q * scale) @ codes.float().T)
    # bytes: the codes, the query block, the scale, the [nq, N] output;
    # FLOP: one d-long dot product per (query, row)
    bms, by = bound(N * DIM + NQ * DIM * 4 + DIM * 4 + NQ * N * 4,
                    2.0 * NQ * N * DIM)
    records["quant_score"] = dict(
        name="quant_score", route="cuda",
        source="src/repro_torch/csrc/quant_score.cu",
        replaces="src/repro/kernels/quant_score.py:40",
        jax="src/repro/kernels/quant_score.py:quant_score_pallas",
        **errors(worst), bound_ms=bms, bound_by=by, **t)
    say(f"quant_score at nq={NQ} N={N} d={DIM}: kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, (q*scale)@codes.T "
        f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"{speed(t, bms)}")

    # -- sq8_topk: edge cases, then the deployment shapes
    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}
    for nq, n, d, k, p in [(3, 32, 8, 8, 1.0), (2, 64, 8, 6, 0.05),
                           (1, 5, 8, 8, 1.0), (1, 129, 24, 4, 0.0),
                           (7, 1000, 64, 5, 0.8), (5, 4101, 48, 16, 0.8),
                           (70, 3000, 32, 128, 0.9),
                           (NQ, N, DIM, K, 0.99)]:
        q, live = unit(nq, d), live_mask(n, p)
        codes, scale = sq8(n, d)
        got = check(f"sq8_topk nq={nq} N={n} d={d} k={k}",
                    compare_topk(*ref.sq8_topk(q, codes, scale, live, k),
                                 *ops.sq8_topk(q, codes, scale, live, k)),
                    "plain")
        say(f"sq8_topk nq={nq} N={n} d={d} k={k} live={p}: max|dscore| "
            f"{got['max_abs_diff']:.3g}, id mismatches {got['id_mismatches']}")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], got["max_abs_diff"])
        worst["id_mismatches"] += got["id_mismatches"]
    n_live = int(live.sum())
    t = timings(torch, lambda: ops.sq8_topk(q, codes, scale, live, K),
                lambda: ref.sq8_topk(q, codes, scale, live, K),
                lambda: torch.topk(torch.where(
                    live[None, :], (q * scale) @ codes.float().T, neg), K))
    # bytes: the live rows' codes, the liveness bytes, the query block, the
    # scale, the outputs; FLOP: one d-long dot product per (query, live row)
    bms, by = bound(n_live * DIM + N + NQ * DIM * 4 + DIM * 4 + NQ * K * 8,
                    2.0 * NQ * n_live * DIM)
    records["sq8_topk"] = dict(
        name="sq8_topk", route="cuda", source="src/repro_torch/csrc/sq8_topk.cu",
        replaces="src/repro/kernels/fused_retrieve.py:122",
        jax="src/repro/kernels/fused_retrieve.py:sq8_topk_pallas",
        **errors(worst), bound_ms=bms, bound_by=by, **t)
    say(f"sq8_topk at nq={NQ} N={N} d={DIM} k={K} ({n_live} live): kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.topk "
        f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"{speed(t, bms)}")
    del q, codes, scale, live

    # -- pq_topk
    def packed(nlist, cap_b, d, m, fill_lo, fill_hi):
        """Buckets filled from the front, 1% tombstones, random codes."""
        cent = unit(nlist, d)
        fill = torch.randint(fill_lo, fill_hi + 1, (nlist,), generator=gen,
                             device=dev)
        pos = torch.arange(cap_b, device=dev)
        member = (pos[None, :] < fill[:, None]).reshape(-1)
        ok = member & live_mask(nlist * cap_b, 0.99)
        codes = torch.randint(0, 256, (nlist * cap_b, m), generator=gen,
                              device=dev, dtype=torch.int32)
        slot = torch.where(member, torch.randperm(
            nlist * cap_b, generator=gen, device=dev).int(), -1).int()
        codebook = 0.3 * torch.randn(m, 256, d // m, generator=gen,
                                     device=dev)
        return cent, codebook, codes, slot, ok

    # tie order: every even packed row's codes repeated in the next one;
    # the sum is the plain version's, in order, so scores are equal
    for nq, nlist, cap_b, d, m, nprobe, k in [(5, 4, 24, 16, 4, 3, 6),
                                              (9, 16, 256, 48, 48, 5, 128)]:
        cent, codebook, codes, slot, ok = packed(nlist, cap_b, d, m, 0, cap_b)
        codes[1::2] = codes[0::2]
        args = (unit(nq, d), codebook, cent, codes, slot, ok, nprobe, k)
        check_ties(torch, f"pq_topk ties nq={nq} cap_b={cap_b} m={m} k={k}",
                   ref.pq_topk(*args), ops.pq_topk(*args))

    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}
    for nq, nlist, cap_b, d, m, nprobe, k, lo, hi in [
            (3, 4, 64, 16, 4, 2, 8, 8, 40), (1, 4, 16, 8, 2, 4, 32, 0, 16),
            (5, 8, 100, 24, 3, 3, 5, 0, 0),
            (9, 16, 256, 64, 16, 5, 128, 50, 256),
            (NQ, NLIST, CAP_B, DIM, PQ_M, NPROBE, K, 512, 1536)]:
        cent, codebook, codes, slot, ok = packed(nlist, cap_b, d, m, lo, hi)
        q = torch.nn.functional.normalize(
            cent[torch.randint(nlist, (nq,), generator=gen, device=dev)]
            + 0.5 * unit(nq, d), dim=1)
        args = (q, codebook, cent, codes, slot, ok, nprobe, k)
        got = check(f"pq_topk nq={nq} nlist={nlist} cap_b={cap_b} m={m}",
                    compare_topk(*ref.pq_topk(*args), *ops.pq_topk(*args)),
                    "plain")
        say(f"pq_topk nq={nq} nlist={nlist} cap_b={cap_b} d={d} m={m} "
            f"nprobe={nprobe} k={k}: max|dscore| {got['max_abs_diff']:.3g}, "
            f"id mismatches {got['id_mismatches']}")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], got["max_abs_diff"])
        worst["id_mismatches"] += got["id_mismatches"]
    pc3, ok2 = codes.view(NLIST, CAP_B, PQ_M), ok.view(NLIST, CAP_B)
    offs = torch.arange(PQ_M, device=dev) * 256

    def library():
        lut = torch.einsum("qms,mcs->qmc", q.view(NQ, PQ_M, -1), codebook)
        probe = torch.topk(q @ cent.T, NPROBE).indices
        fidx = (pc3[probe].long() + offs).view(NQ, -1)
        s = torch.gather(lut.reshape(NQ, -1), 1, fidx).view(
            NQ, NPROBE * CAP_B, PQ_M).sum(-1)
        return torch.topk(torch.where(ok2[probe].view(NQ, -1), s, neg), K)

    t = timings(torch, lambda: ops.pq_topk(*args),
                lambda: ref.pq_topk(*args), library)
    # the kernel alone, its wrapper's probe, tables and merge done once
    from repro_torch.kernels import _build
    lib, fn = _build.entry("pq_topk", 7, 5)
    lut = ref.pq_lut(q, codebook).contiguous()
    probes = ref.probe(q, cent, NPROBE)
    out_s = torch.empty((NQ, NPROBE, K), device=dev)
    out_i = torch.empty((NQ, NPROBE, K), dtype=torch.int32, device=dev)
    launch = [lut.data_ptr(), codes.data_ptr(), slot.data_ptr(),
              ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
              out_s.data_ptr(), out_i.data_ptr(), NQ, PQ_M, CAP_B, NPROBE, K,
              torch.cuda.current_stream(dev).cuda_stream]
    _build.check(lib, "pq_topk", fn(*launch))
    t["kernel_only_ms"] = kernel_ms(lambda: fn(*launch), torch)
    # bytes: every probed bucket's ok bytes and its ok rows' codes once, the
    # slot ids of the rows a (query, probe) emits, the query block, the
    # centroids, the codebook, the outputs; operations: m table adds per
    # (query, probed ok row), the probe's centroid scores and the tables
    probe = ref.probe(q, cent, NPROBE).long()
    ok_rows = ok2.sum(1)
    buckets = torch.unique(probe)
    n_bytes = (int(ok_rows[buckets].sum()) * PQ_M * 4 + len(buckets) * CAP_B
               + int(ok_rows[probe].clamp(max=K).sum()) * 4
               + NQ * DIM * 4 + NLIST * DIM * 4 + codebook.numel() * 4
               + NQ * K * 8)
    n_ops = (float(int(ok_rows[probe].sum()) * PQ_M)
             + 2.0 * NQ * DIM * (NLIST + 256))
    bms, by = bound(n_bytes, n_ops)
    records["pq_topk"] = dict(
        name="pq_topk", route="cuda", source="src/repro_torch/csrc/pq_topk.cu",
        replaces="src/repro/kernels/fused_retrieve.py:376",
        jax="src/repro/kernels/fused_retrieve.py:pq_topk_pallas",
        **errors(worst), bound_ms=bms, bound_by=by, **t)
    say(f"pq_topk at nq={NQ} nlist={NLIST} cap_b={CAP_B} m={PQ_M} "
        f"nprobe={NPROBE} k={K} ({len(buckets)} buckets probed, "
        f"{int(ok_rows[probe].sum())} (query, ok row) pairs): kernel "
        f"{t['ms']:.4f} ms (the kernel alone {t['kernel_only_ms']:.4f} ms), "
        f"plain {t['plain_ms']:.4f} ms, "
        f"gather+sum+topk {t['library_ms']:.4f} ms, bound {bms:.4f} ms "
        f"({by}); {speed(t, bms)}")
    return records


def make_rows(torch):
    """One seeded row set for the three DB phases: N clustered unit rows,
    N_FRESH fresh rows, the removed documents (1% of them; row s belongs to
    document s // 4) and 20 batches of NQ queries near surviving rows."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    centers = torch.nn.functional.normalize(
        torch.randn(4096, DIM, generator=gen, device=dev), dim=1)
    pick = torch.randint(4096, (N + N_FRESH,), generator=gen, device=dev)
    rows = torch.nn.functional.normalize(
        centers[pick] + 0.6 * torch.nn.functional.normalize(
            torch.randn(N + N_FRESH, DIM, generator=gen, device=dev), dim=1),
        dim=1)
    n_docs = (N + N_FRESH) // 4
    gone = torch.randperm(n_docs, generator=torch.Generator().manual_seed(2))[
        :n_docs // 100]
    live = torch.ones(N + N_FRESH, dtype=torch.bool, device=dev)
    live[(gone[:, None] * 4 + torch.arange(4)).reshape(-1).to(dev)] = False
    picks = torch.nonzero(live)[:, 0]
    batches = []
    for _ in range(20):
        at = picks[torch.randint(len(picks), (NQ,), generator=gen, device=dev)]
        batches.append(torch.nn.functional.normalize(
            rows[at] + 0.1 * torch.randn(NQ, DIM, generator=gen, device=dev),
            dim=1))
    return {"rows": rows, "gone": gone.tolist(), "batches": batches}


def run_db(torch, ops, ref, compare_topk, data, name, cfg, rungs, kernels,
           off_chunk):
    """Build a ``TorchVectorDB`` at deployment size from ``data``, mutate
    it, and search it on each of ``rungs`` ({rung: kernels it must
    launch}); every rung must equal the plain ``off`` rung (compared
    ``off_chunk`` queries at a time). ``kernels(db, q, main_live)`` gives
    the main index's kernel calls to time alone. Returns the launch counts
    of each rung's 20 searches."""
    import numpy as np

    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB

    dev = torch.device(DEVICE)
    rows, batches = data["rows"], data["batches"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    db = TorchVectorDB(DBConfig(dim=DIM, capacity=DB_CAPACITY,
                                flat_capacity=FLAT_CAPACITY, **cfg),
                       device=DEVICE)
    t0 = time.perf_counter()
    step = min(1 << 17, N)
    for lo in range(0, N, step):
        db.insert(rows[lo:lo + step], [Chunk(-1, (lo + i) // 4, "")
                                       for i in range(step)])
    t1 = time.perf_counter()
    db.build_index()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # a flat index counts as built from the start, so its bulk inserts
    # already fold the buffer in; what matters is that the fresh rows stay
    rebuilds = db.counters["rebuilds"]
    db.insert(rows[N:], [Chunk(-1, (N + i) // 4, "") for i in range(N_FRESH)])
    removed = sum(db.remove(d) for d in data["gone"])
    st = db.stats()
    fill = (f" (max bucket fill {int(db.bucket_live.sum(1).max())} of "
            f"{CAP_B})" if db.bucket_live is not None else "")
    say(f"{name}: inserted {N} rows in {t1 - t0:.1f} s, build_index "
        f"{t2 - t1:.1f} s{fill}, {N_FRESH} fresh rows, {removed} rows of "
        f"{len(data['gone'])} docs removed; live {int(st['live'])}, fresh "
        f"{int(st['fresh'])}, rebuilds {int(st['rebuilds'])}, index_bytes "
        f"{int(st['index_bytes'])}")
    if st["rebuilds"] != rebuilds or st["fresh"] == 0:
        raise AssertionError("the freshness buffer was folded in: no scan")

    results, launches = {}, {}
    for rung, need in rungs.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if rung == db._kernel:     # the configured rung: the user's call
            res = [db.search(q.cpu().numpy(), K) for q in batches]
            out = [(torch.from_numpy(np.stack([r.scores for r in b])),
                    torch.from_numpy(np.stack([r.chunk_ids for r in b])))
                   for b in res]
            how = "search() entry to numpy results"
        else:
            out = [tuple(t.cpu() for t in db.search_arrays(q, K, rung=rung))
                   for q in batches]
            how = "search_arrays(rung) to host tensors"
        ms = 1e3 * (time.perf_counter() - t0) / len(batches)
        launches[rung] = ops.launch_counts()
        say(f"{name}: {rung} rung, 20 batches of {NQ} queries at k={K}: "
            f"{ms:.3f} ms per batch (host clock, {how}); launches "
            f"{launches[rung]}")
        for kname in need:
            if launches[rung][kname] == 0:
                raise AssertionError(f"{name}: the {rung} rung never "
                                     f"launched {kname}")
        results[rung] = [(s.to(dev), i.to(dev)) for s, i in out]

    live_rows = torch.from_numpy(db.live).to(dev)
    worst, hits = 0.0, {rung: 0 for rung in rungs}
    for b, q in enumerate(batches):
        for lo in range(0, NQ, off_chunk):
            s_off, i_off = db.search_arrays(q[lo:lo + off_chunk], K,
                                            rung="off")
            for rung in rungs:
                s, i = results[rung][b]
                got = check(f"{name} {rung} rung", compare_topk(
                    s_off, i_off, s[lo:lo + off_chunk],
                    i[lo:lo + off_chunk]), "off rung")
                worst = max(worst, got["max_abs_diff"])
        _, exact = ref.topk_search(q, db.vectors, live_rows, K)
        for rung in rungs:
            ids = results[rung][b][1]
            hits[rung] += sum(len(set(a.tolist()) & set(e.tolist()))
                              for a, e in zip(ids, exact))
    recall = {rung: h / (len(batches) * NQ * K) for rung, h in hits.items()}
    say(f"{name}: {', '.join(rungs)} equal the off rung (max|dscore| "
        f"{worst:.3g}); recall@{K} against exact fp32 search "
        + ", ".join(f"{r} {v:.4f}" for r, v in recall.items())
        + f"; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where a search's time goes: the main index's kernels alone, the
    # freshness scan alone, the device-side search, search() (CUDA events)
    q = batches[0]
    main_live = torch.from_numpy(db.live & db.indexed).to(dev)
    fresh = torch.from_numpy(db.live & ~db.indexed).to(dev)
    q_np = q.cpu().numpy()
    parts = {part: median_ms(fn, torch)
             for part, fn in kernels(db, q, main_live).items()}
    parts["freshness topk_search"] = median_ms(
        lambda: ops.topk_search(q, db.vectors, fresh, K), torch)
    for rung in rungs:
        parts[f"search_arrays {rung}"] = median_ms(
            lambda: db.search_arrays(q, K, rung=rung), torch)
    parts["search"] = median_ms(lambda: db.search(q_np, K), torch)
    say(f"{name}: per batch of {NQ} queries (ms, median of {RUNS}): "
        + ", ".join(f"{part} {t:.4f}" for part, t in parts.items()))
    del db
    torch.cuda.empty_cache()
    return launches


def phase_dbs(torch, ops, ref, compare_topk):
    """The three deployment-size DBs from one row set, each freed before
    the next; returns each kernel's launches in the DB run that drives
    it."""
    data = make_rows(torch)

    def packed_ok(db, main_live):
        slot = db.packed["slot"]
        return slot, (slot >= 0) & main_live[slot.clamp(min=0)]

    def ivf_kernels(db, q, main_live):
        slot, ok = packed_ok(db, main_live)
        return {"ivf_topk": lambda: ops.ivf_topk(
            q, db.centroids, db.packed["vecs"], slot, ok, NPROBE, K)}

    def sq8_kernels(db, q, main_live):
        return {"sq8_topk": lambda: ops.sq8_topk(
                    q, db.sq_codes, db.sq_scale, main_live, K),
                "quant_score": lambda: ops.quant_score(
                    q, db.sq_codes, db.sq_scale),
                "quant_score + stable top-k": lambda: ref.masked_topk(
                    ops.quant_score(q, db.sq_codes, db.sq_scale), main_live,
                    K)}

    def pq_kernels(db, q, main_live):
        slot, ok = packed_ok(db, main_live)
        return {"pq_topk": lambda: ops.pq_topk(
            q, db.pq_codebook, db.centroids, db.packed["codes"], slot, ok,
            NPROBE, K)}

    ivf = dict(index_type="ivf", nlist=NLIST, nprobe=NPROBE, bucket_cap=CAP_B)
    launches = {}
    t0 = time.perf_counter()
    got = run_db(torch, ops, ref, compare_topk, data, "db ivf", dict(
        ivf, use_kernel="fused"), {"fused": ("ivf_topk", "topk_search")},
        ivf_kernels, off_chunk=8)
    launches.update(topk_search=got["fused"]["topk_search"],
                    ivf_topk=got["fused"]["ivf_topk"])
    say(f"db ivf: phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    got = run_db(torch, ops, ref, compare_topk, data, "db flat+sq8", dict(
        index_type="flat", quant="sq8", use_kernel="fused"),
        {"fused": ("sq8_topk", "topk_search"),
         "op": ("quant_score", "topk_search")}, sq8_kernels, off_chunk=NQ)
    launches.update(sq8_topk=got["fused"]["sq8_topk"],
                    quant_score=got["op"]["quant_score"])
    say(f"db flat+sq8: phase {time.perf_counter() - t0:.1f} s")

    from repro_torch.core import vectordb

    t0 = time.perf_counter()
    pq_s = []
    train = vectordb.TorchVectorDB._train_pq

    def timed_train(self, live_idx):   # PQ training's share of the build
        t = time.perf_counter()
        train(self, live_idx)
        torch.cuda.synchronize()
        pq_s.append(time.perf_counter() - t)

    vectordb.TorchVectorDB._train_pq = timed_train
    try:
        got = run_db(torch, ops, ref, compare_topk, data, "db ivf+pq", dict(
            ivf, quant="pq", pq_m=PQ_M, use_kernel="fused"),
            {"fused": ("pq_topk", "topk_search")}, pq_kernels, off_chunk=8)
    finally:
        vectordb.TorchVectorDB._train_pq = train
    launches.update(pq_topk=got["fused"]["pq_topk"])
    say(f"db ivf+pq: PQ training {sum(pq_s):.1f} s (within build_index); "
        f"phase {time.perf_counter() - t0:.1f} s")
    return launches


SERVE_SPECS = {          # spec -> the kernels its run must launch
    "fused_ivf": ("ivf_topk", "topk_search"),
    "fused_flat_sq8": ("sq8_topk", "topk_search"),
    "op_flat_sq8": ("quant_score", "topk_search"),
    "fused_ivf_pq": ("pq_topk", "topk_search"),
}


def phase_serve(torch, ops):
    from repro_torch.launch import serve

    for spec, need in SERVE_SPECS.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        doc = serve.main(["--config", str(SRC / "repro_torch" / "specs" /
                                          f"{spec}.json"),
                          "--mode", "sync", "--docs", "256", "--requests",
                          "64", "--device", DEVICE])
        launches = ops.launch_counts()
        say(f"serve {spec}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches}, db index_bytes {int(doc['db']['index_bytes'])}")
        if not doc["quality"] or min(launches[k] for k in need) == 0:
            raise AssertionError(f"serve {spec} did not run {need} with a "
                                 f"quality report: {launches} "
                                 f"{doc['quality']}")


# (B, H, Hkv, S, dh, causal) of the kernel's callers on the model path
FLASH_SHAPES = {
    "llm prefill": (8, 32, 8, 512, 128, True),      # Llama-3-8B, batch 8
    "llm prefill S=500": (8, 32, 8, 500, 128, True),   # ragged last tile
    "embedder": (64, 4, 4, 128, 64, False),         # d_model 256, batch 64
    "cross-encoder": (32, 4, 4, 192, 64, False),    # d_model 256, batch 32
}


def row_rel_err(got, want) -> float:
    """The worst query row's ||got - want|| / ||want|| over the head dim,
    in fp32."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def dropped_tile_attention(torch, q, k, v, causal):
    """A planted fault for the row check: fp32 attention in which the K/V
    tile of keys [64, 128) is skipped by every query row whose q tile reads
    all of it (every row when not causal, rows from 128 on when causal)."""
    rep = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(rep, 1).float() for x in (k, v))
    S = q.shape[2]
    i = torch.arange(S, device=q.device)
    rows = i[:, None] >= (128 if causal else 0)
    mask = rows & (i[None, :] >= 64) & (i[None, :] < 128)
    if causal:
        mask |= i[None, :] > i[:, None]
    s = (q.float() @ k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    return torch.softmax(s.masked_fill(mask, float("-inf")), -1) @ v


def phase_flash(torch, ops, ref):
    """flash_attention against its plain version; returns its record."""
    import torch.nn.functional as F

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def qkv(B, H, Hkv, S, dh, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, H, S, dh), (B, Hkv, S, dh),
                              (B, Hkv, S, dh))]

    worst = 0.0
    cases = [(1, 2, 2, 64, 16, True, "float32"),     # the reference's tests
             (2, 4, 2, 128, 32, True, "float32"),
             (2, 4, 1, 128, 64, False, "float32"),
             (1, 8, 8, 256, 32, True, "bfloat16")]
    dhs = (16, 32, 64, 128)
    for i, (S, (H, hkv), causal) in enumerate(
            (S, g, c) for S in (1, 63, 65, 192)
            for g in ((4, 4), (6, 2), (8, 2)) for c in (True, False)):
        cases.append((2, H, hkv, S, dhs[i % 4], causal,
                      ("bfloat16", "float32")[i % 2]))
    for B, H, hkv, S, dh, causal, dt in cases:
        q, k, v = qkv(B, H, hkv, S, dh, dtypes[dt])
        got = ops.flash_attention(q, k, v, causal=causal).float()
        want = ref.flash_attention(q, k, v, causal=causal).float()
        err = float((got - want).abs().max())
        tol = ATTN_TOL[dt]
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            raise AssertionError(f"flash_attention B={B} H={H} Hkv={hkv} "
                                 f"S={S} dh={dh} causal={causal} {dt} "
                                 f"disagrees with plain: max|d| {err}")
        worst = max(worst, err)
    say(f"flash_attention: {len(cases)} shapes equal the plain version "
        f"within {ATTN_TOL} (max|d| {worst:.3g})")
    for dt, dtype in dtypes.items():
        q, k, v = qkv(2, 6, 2, 130, 64, dtype)
        out = ops.flash_attention(q, k, v, causal=True)
        if not torch.equal(out[:, :, 0], v.repeat_interleave(3, 1)[:, :, 0]):
            raise AssertionError(f"flash_attention {dt}: causal row 0 is not "
                                 f"v[0]")
    say("flash_attention: causal row 0 equals v[0] exactly (bf16, fp32)")

    record = None
    for name, (B, H, hkv, S, dh, causal) in FLASH_SHAPES.items():
        q, k, v = qkv(B, H, hkv, S, dh, torch.bfloat16)
        got = ops.flash_attention(q, k, v, causal=causal).float()
        want = ref.flash_attention(q, k, v, causal=causal).float()
        tol = ATTN_TOL["bfloat16"]
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            raise AssertionError(f"flash_attention {name} disagrees with "
                                 f"plain")
        worst = max(worst, float((got - want).abs().max()))
        rel = row_rel_err(got, want)
        fault = row_rel_err(dropped_tile_attention(torch, q, k, v, causal),
                            want)
        glob = float((got - want).norm() / want.norm())
        say(f"flash_attention {name}: worst row ||d||/||want|| {rel:.4g} "
            f"(limit {ATTN_ROW_REL_LIMIT}; with one K/V tile dropped "
            f"{fault:.4g}), whole tensor {glob:.4g}")
        if not rel <= ATTN_ROW_REL_LIMIT < fault:
            raise AssertionError(f"flash_attention {name}: worst row error "
                                 f"{rel} against limit "
                                 f"{ATTN_ROW_REL_LIMIT}, fault {fault}")
        kr, vr = (x.repeat_interleave(H // hkv, 1) for x in (k, v))
        t = timings(torch,
                    lambda: ops.flash_attention(q, k, v, causal=causal),
                    lambda: ref.flash_attention(q, k, v, causal=causal),
                    lambda: F.scaled_dot_product_attention(
                        q, kr, vr, is_causal=causal))
        # bytes: q, k, v read once and o written once (bf16); FLOP: the two
        # products, 4*B*H*S^2*dh, halved when causal
        n_bytes = 2 * (2 * B * H * S * dh + 2 * B * hkv * S * dh)
        n_flop = 4.0 * B * H * S * S * dh / (2 if causal else 1)
        bms, by = bound(n_bytes, n_flop, BF16_FLOP_PER_S)
        say(f"flash_attention {name} B={B} H={H} Hkv={hkv} S={S} dh={dh} "
            f"causal={causal} bf16: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention (K/V "
            f"repeated) {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"{n_bytes / 1e6:.1f} MB, {n_flop / 1e9:.2f} GFLOP); "
            f"{speed(t, bms)}")
        if record is None:       # the LLM prefill: the record's shape
            record = dict(name="flash_attention", route="cuda",
                          source="src/repro_torch/csrc/flash_attention.cu",
                          replaces="src/repro/kernels/flash_attention.py:85",
                          jax="src/repro/kernels/flash_attention.py:"
                              "flash_attention_pallas",
                          bound_ms=bms, bound_by=by, **t, other_shapes={})
        else:
            record["other_shapes"][name] = dict(bound_ms=bms, **t)
        del q, k, v, kr, vr, got, want
    record["max_abs_err"] = worst
    return record


def greedy_gaps(torch, model, prompts, lengths, ids):
    """The top-1 minus top-2 logit of ``model`` at each greedy step, from a
    full forward over each prompt and the tokens generated after it."""
    gaps = []
    with torch.inference_mode():
        for row, n, out in zip(prompts, lengths, ids):
            seq = torch.cat([torch.as_tensor(row[:n]).long(),
                             torch.as_tensor(out[:-1]).long()])[None]
            top = model(seq.to(model.device))[0, n - 1:].float().topk(2).values
            gaps.append((top[:, 0] - top[:, 1]).cpu())
    return torch.stack(gaps).numpy()


def phase_model_smoke(torch, ops):
    """One seeded llama3 smoke model on the CPU (plain attention) and on
    the card (the kernel), in fp32 and in bf16: prefill logits within
    LOGIT_TOL, 8 greedy tokens equal by the near-tie rule."""
    for dtype in LOGIT_TOL:
        model_smoke(torch, ops, dtype)


def model_smoke(torch, ops, dtype):
    import copy

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.generator import ModelLLM, build_prompt
    from repro_torch.core.interfaces import Chunk
    from repro_torch.kernels.parity import compare_tokens

    cfg = configs.get_smoke("llama3_8b").replace(dtype=dtype)
    tol = LOGIT_TOL[dtype]
    cpu = ModelLLM(cfg, max_prompt=64, max_new=8, batch_size=4, seed=0,
                   device="cpu")
    card = ModelLLM(cfg, max_prompt=64, max_new=8, batch_size=4,
                    device=DEVICE, model=copy.deepcopy(cpu.model).to(DEVICE))
    questions = [f"what is the color of item-{i}" for i in range(6)]
    ctxs = [[Chunk(i, i, f"the color of item-{i} is shade-{i % 5} " *
                   (1 + 3 * i))] for i in range(6)]
    prompts = cpu.tok.encode_batch([build_prompt(q, c) for q, c in
                                    zip(questions, ctxs)], 64)
    lengths = np.maximum((prompts != 0).sum(1), 1)
    with torch.inference_mode():
        want, _ = cpu.model.prefill(torch.from_numpy(prompts),
                                    cpu.model.init_cache(6, 72),
                                    lengths=torch.from_numpy(lengths))
        ops.reset_launch_counts()
        got, _ = card.model.prefill(torch.from_numpy(prompts).to(DEVICE),
                                    card.model.init_cache(6, 72),
                                    lengths=torch.from_numpy(lengths).to(
                                        DEVICE))
    launches = ops.launch_counts()["flash_attention"]
    diff = float((got.cpu().float() - want.float()).abs().max())
    if not diff <= tol or launches != cfg.n_layers:
        raise AssertionError(f"smoke model {dtype} prefill: card vs CPU "
                             f"max|d| {diff}, {launches} flash launches")
    ref_ids = [[int(w[3:]) for w in a.split()]
               for a in cpu.generate(questions, ctxs)]
    ids = [[int(w[3:]) for w in a.split()]
           for a in card.generate(questions, ctxs)]
    gaps = greedy_gaps(torch, cpu.model, prompts, lengths, ref_ids)
    res = compare_tokens(np.array(ref_ids), np.array(ids), gaps, tol)
    if res["violations"]:
        raise AssertionError(f"smoke model {dtype} tokens: card {ids} vs "
                             f"CPU {ref_ids} ({res})")
    say(f"model smoke ({dtype} llama3 smoke, 6 prompts of up to 64 tokens): "
        f"prefill logits card vs CPU max|d| {diff:.3g} (tolerance "
        f"{tol}), {launches} flash launches; 8 greedy tokens, "
        f"{res['mismatch_rows']} rows differ, smallest reference top-2 gap "
        f"{float(gaps.min()):.3g}")


def time_model(torch, model) -> None:
    """Where a generate batch's time goes, at the serving spec's shape
    (8 rows padded to 512 tokens, real lengths 250-350): the prefill and
    one decode step (CUDA events, median of RUNS), and the kernels one
    decode step launches with their device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    B, S, new = 8, 512, 16
    V = model.cfg.vocab_size
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    lengths = torch.randint(250, 351, (B,), generator=gen, device=DEVICE)
    tokens = torch.randint(4, V, (B, S), generator=gen, device=DEVICE)
    tokens[torch.arange(S, device=DEVICE)[None, :] >= lengths[:, None]] = 0
    with torch.inference_mode():
        cache = model.init_cache(B, S + new + 2 * RUNS + 8)
        prefill_ms = median_ms(lambda: model.prefill(tokens, cache,
                                                     lengths=lengths), torch)
        logits, cache = model.prefill(tokens, cache, lengths=lengths)
        cur = logits.argmax(-1)[:, None]
        step_ms = median_ms(lambda: model.decode_step(cur, cache), torch)
        steps = 4
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                logits, cache = model.decode_step(cur, cache)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in kernels) / steps
    busy_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    # bound of a decode step: every weight read once (16 GB)
    bound_step = 1e3 * 2 * model.cfg.param_count() / HBM_BYTES_PER_S
    head = (f"llama3_8b at B={B}, S={S}: prefill {prefill_ms:.2f} ms, "
            f"decode step {step_ms:.2f} ms (bound {bound_step:.2f} ms: the "
            f"weights read once)")
    if not kernels:
        say(f"{head}; kernels per decode step and device time not measured "
            f"(the profiler saw no device activity)")
        return
    say(f"{head}; one decode step launches {n_kernels:.0f} kernels, device "
        f"busy {busy_ms:.2f} ms of it (idle share "
        f"{1 - busy_ms / step_ms:.3f}); most device time: "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / steps / 1e3:.3f}"
                    f" ms" for e in top))


def phase_model_full(torch, ops):
    """Llama-3-8B at full width on the card: the parameter count, then the
    RAG pipeline served with it; returns flash_attention's launches in the
    serve run."""
    from repro_torch import configs
    from repro_torch.core import embedder, reranker
    from repro_torch.launch import serve
    from repro_torch.models import api, transformer

    cfg = configs.get_config("llama3_8b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = api.count_params(model)
    if n_params != LLAMA3_8B_PARAMS:
        raise AssertionError(f"llama3_8b has {n_params} parameters")
    tokens = torch.randint(4, cfg.vocab_size, (2, 64), device=DEVICE)
    with torch.inference_mode():
        logits, _ = model.prefill(tokens, model.init_cache(2, 64))
    if logits.shape != (2, cfg.vocab_size) or not bool(
            logits.float().isfinite().all()):
        raise AssertionError(f"llama3_8b prefill logits {logits.shape} "
                             f"are not finite")
    say(f"llama3_8b: {n_params} parameters "
        f"({api.param_bytes(model) / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; prefill logits finite")
    time_model(torch, model)
    del model, logits
    torch.cuda.empty_cache()

    # every consumer's batch launches flash_attention once per layer
    batches = {"prefill": 0, "embed": 0, "cross": 0}
    wrapped = [(transformer.Transformer, "prefill", "prefill"),
               (embedder, "_encode_fn", "embed"),
               (reranker, "_cross_score", "cross")]
    saved = [getattr(owner, attr) for owner, attr, _ in wrapped]

    def counting(fn, key):
        def call(*args, **kw):
            batches[key] += 1
            return fn(*args, **kw)
        return call

    for (owner, attr, key), fn in zip(wrapped, saved):
        setattr(owner, attr, counting(fn, key))
    spec = SRC / "repro_torch" / "specs" / "model_llama3_8b.json"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        doc = serve.main(["--config", str(spec), "--mode", "sync", "--docs",
                          "256", "--requests", "48", "--device", DEVICE])
    finally:
        for (owner, attr, _), fn in zip(wrapped, saved):
            setattr(owner, attr, fn)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    # one launch per layer: 32 in the generator, 4 in each encoder
    want = (cfg.n_layers * batches["prefill"]
            + ENCODER_LAYERS * (batches["embed"] + batches["cross"]))
    gen = doc["gen"]
    n_queries = doc["ops"].get("query", 0)
    if (launches["flash_attention"] != want or not gen
            or gen["n_requests"] != n_queries or n_queries == 0
            or gen["tokens_out"] != 16 * n_queries
            or sum(doc["ops"].values()) != 48
            or min(launches["ivf_topk"], launches["topk_search"]) == 0):
        raise AssertionError(f"serve model_llama3_8b: launches {launches} "
                             f"(flash want {want} from {batches}), ops "
                             f"{doc['ops']}, gen {gen}")
    tok_s = gen["tokens_out"] / doc["stage_breakdown"]["generation"]
    say(f"serve model_llama3_8b: {sum(doc['ops'].values())} requests "
        f"({doc['ops']}) in {wall:.1f} s, every query answered with 16 "
        f"tokens; batches {batches}; launches {launches}; TTFT p50 "
        f"{1e3 * gen['ttft_p50_s']:.2f} ms, TPOT p50 "
        f"{1e3 * gen['tpot_p50_s']:.2f} ms, {tok_s:.1f} generated tokens/s "
        f"over the generation stage; stage breakdown (s) "
        f"{ {k: round(v, 3) for k, v in doc['stage_breakdown'].items()} }; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches["flash_attention"]


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
    # shared memory per block each launcher requests, at the main path's
    # row widths and k (flash_attention: the Hopper kernel at dh 128 and 64)
    widths = {"topk_search": [DIM], "ivf_topk": [DIM], "quant_score": [DIM],
              "sq8_topk": [DIM], "pq_topk": [PQ_M],
              "flash_attention": [128, 64]}
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")
        say(f"  {name}: shared memory per block " + ", ".join(
            f"{_build.smem_bytes(name, d, K)} bytes at width {d}"
            for d in widths[name]))

    timings = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    records = phase_kernels(torch, ops, ref, compare_topk)
    timings["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records.update(phase_quant_kernels(torch, ops, ref, compare_topk))
    timings["quantized kernels"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    db_launches = phase_dbs(torch, ops, ref, compare_topk)
    timings["dbs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_serve(torch, ops)
    timings["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records["flash_attention"] = phase_flash(torch, ops, ref)
    timings["flash kernel"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_model_smoke(torch, ops)
    timings["model smoke"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash_launches = phase_model_full(torch, ops)
    timings["model full width"] = time.perf_counter() - t0
    say("phase wall seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in timings.items()))

    kernels = []
    for name, rec in records.items():
        rec["launches"] = (flash_launches if name == "flash_attention"
                           else db_launches[name])
        kernels.append(rec)
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
