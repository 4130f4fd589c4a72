#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure and prints its wall seconds:

1. the card: ``nvidia-smi`` name and power limit, the torch version;
2. build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc, one
   process per source, all at once; each library's registers, spills and
   shared memory per block;
3. kernels against their plain versions, on the card: tie order on
   exact-arithmetic inputs (ids and scores equal; for topk_search and
   sq8_topk also across the several tiles one block folds, sq8_topk at d
   32, 768 and 1,024; for ivf_topk across two probed buckets, for pq_topk
   across two buckets of one probe group), quant_score and sq8_topk bit
   for bit against their int8 limb model with the limbs resident and
   streamed (quant_score at d 8 to 2,052 on both load paths, sq8_topk at
   d 24 and 2,052 by cp.async and 384, 768, 1,024 by TMA), pq_topk on the
   reference's int32 codes against its uint8 mirror, the edge-case shapes
   and the deployment shapes (64 queries; 1,048,576 x 384 fp32 rows or
   int8 codes; IVF with 1024 lists of 4096 slots, nprobe 16, and the main
   path's IVF16 at nprobe 8 and 4, with the bytes ivf_topk reads against
   a (query, probe) grid's and the bound's; PQ with 48 subspaces; k 16;
   sq8_topk also at d 768 and 1,024), with the time of the kernel's
   wrapper, its plain version and one PyTorch yardstick (CUDA events,
   medians of 20: around 10 back-to-back calls and around single calls),
   the kernel's ratio to the yardstick under both and its share of its
   bound on this card (int8 products at the int8 tensor cores' rate);
   topk_search, quant_score, sq8_topk and pq_topk also through their C
   entry points alone. topk_search and ivf_topk, then quant_score,
   sq8_topk and pq_topk;
4. the vector DB at deployment size (``TorchVectorDB``), three
   configurations built one after the other from one seeded row set:
   1,048,576 clustered unit rows, the index build, 32,768 fresh rows in the
   freshness buffer, 1% of the documents removed, 20 batches of 64 queries:
   IVF1024 (``fused`` rung: ivf_topk + topk_search), flat + SQ8 (``fused``
   rung: sq8_topk + topk_search; ``op`` rung: quant_score + topk_search,
   selecting by (score, row) keys) and IVF1024 + PQ48 (``fused`` rung:
   pq_topk + topk_search); then flat + SQ8 at d 768 (262,144 rows, 8,192
   fresh) on ``fused`` and ``op``. Every rung's results must equal the
   plain ``off`` rung on the same state; the launch counts of each rung's
   run show it went through its kernels;
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
   and cross-encoder batch;
9. serving: every registered scenario but ``shard_scale`` (the sharded DB
   is not ported) simulated at its ``golden_variant`` size on the fused DB
   (``ivf_topk`` and the freshness ``topk_search``) on the card and on the
   CPU: timing fields, scale events, knob timeline and fault events equal,
   every request's ids equal by the near-tie rule and its answer equal
   where they are, quality within SIM_QUALITY_TOL; ``steady``,
   ``update_storm`` and ``replica_failure`` served live on the card (every
   request answered but the injected kills'); ``model_llama3_8b.json``
   served closed-loop at concurrency 8 (its rate R), open-loop Poisson at
   0.5 R and 0.9 R, and elastic at 0.9 R with up to 2 replicas and a
   Chrome trace under ``build/`` (no failed request, the kernels launched,
   the elastic run's peak memory at most the closed run's + 2 GiB); and
   ``--stage-pipeline`` on ``fused_ivf.json``, whose pipelined outputs
   must equal the lock-step ones.

The last lines are one JSON object on the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a card, or run
outside a checkout, it exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import re
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
INT8_OPS_PER_S = 1979e12   # tensor cores, dense
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


def kernel_name(mangled: str) -> str:
    """A kernel's name and integer or bool template arguments from its
    mangled name, as in ``quant_score_kernel<0, false>``: the source name
    is the length-prefixed part that ends in ``kernel``."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[i:m.end()])]
            if name.endswith("kernel") and name.isidentifier():
                rest = mangled[m.end() + len(name):]
                tmpl = re.match(r"I((?:L[ib]-?\d+E)+)E", rest)
                args = [("false", "true")[int(v)] if t == "b" else v
                        for t, v in re.findall(r"L([ib])(-?\d+)E",
                                               tmpl.group(1) if tmpl else "")]
                return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


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


def limb_scores(torch, tfr, q, codes, scale, rows=1 << 17):
    """``fused_retrieve.sq8_limb_scores`` of ``q * scale`` against
    ``codes``, ``rows`` code rows at a time (its fp64 products hold 8 bytes
    a code)."""
    limbs, e = tfr.sq8_limbs(q * scale[None, :])
    return torch.cat([tfr.sq8_limb_scores(limbs, e, codes[lo:lo + rows])
                      for lo in range(0, codes.shape[0], rows)], 1)


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


def ivf_packed(torch, draw, nlist, cap_b, d, fill_lo, fill_hi):
    """A packed IVF mirror from ``draw`` (``draws``' makers): clustered
    buckets filled from the front, 1% tombstones."""
    gen, unit, live_mask, _ = draw
    dev = torch.device(DEVICE)
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


def ivf_case(torch, draw, nq, nlist, cap_b, d, nprobe, k, lo, hi):
    """``ops.ivf_topk``'s arguments: a packed mirror and queries near its
    centroids."""
    gen, unit = draw[:2]
    cent, pv, slot, ok = ivf_packed(torch, draw, nlist, cap_b, d, lo, hi)
    q = torch.nn.functional.normalize(
        cent[torch.randint(nlist, (nq,), generator=gen,
                           device=torch.device(DEVICE))]
        + 0.5 * unit(nq, d), dim=1)
    return q, cent, pv, slot, ok, nprobe, k


def phase_kernels(torch, ops, ref, compare_topk):
    """Every kernel against its plain version; returns the kernel records
    and the IVF calls to profile by kernel once every timing is taken, as
    (shape, maker of a call)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import topk_search as tts

    dev = torch.device(DEVICE)
    draw = draws(torch, 0)
    gen, unit, live_mask, grid = draw
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

    profiles = []

    def profiled(*shape):
        """A maker of an ``ops.ivf_topk`` call at ``shape`` on inputs of
        their own (seed 1), drawn when it is called."""
        def make():
            args = ivf_case(torch, draws(torch, 1), *shape)
            return lambda: ops.ivf_topk(*args)
        return make

    # tie order: every even packed row repeated in the next one
    for nq, nlist, cap_b, d, nprobe, k in [(5, 4, 24, 16, 3, 6),
                                           (9, 16, 256, 64, 5, 128)]:
        cent, pv, slot, ok = ivf_packed(torch, draw, nlist, cap_b, d, 0,
                                        cap_b)
        pv = grid(nlist * cap_b, d)
        pv[1::2] = pv[0::2]
        q = grid(nq, d)
        args = (q, cent, pv, slot, ok, nprobe, k)
        check_ties(torch, f"ivf_topk ties nq={nq} cap_b={cap_b} k={k}",
                   ref.ivf_topk(*args), ops.ivf_topk(*args))
    for nq, nlist, cap_b, d, nprobe, k, lo, hi in [
            (3, 4, 64, 16, 2, 8, 8, 40), (1, 4, 16, 8, 4, 32, 0, 16),
            (5, 8, 100, 24, 3, 5, 0, 0), (9, 16, 256, 64, 5, 128, 50, 256),
            (NQ, NLIST, CAP_B, DIM, NPROBE, K, 512, 1536),   # deployment
            (70, 8, 120, 772, 5, 16, 0, 120),
            (NQ, 16, 512, DIM, 8, K, 96, 160),     # the main path's IVF16
            (NQ, 16, 2048, DIM, 4, K, 384, 640)]:  # fused_ivf.json
        args = ivf_case(torch, draw, nq, nlist, cap_b, d, nprobe, k, lo, hi)
        got = check(f"ivf_topk nq={nq} nlist={nlist} cap_b={cap_b}",
                    compare_topk(*ref.ivf_topk(*args), *ops.ivf_topk(*args)),
                    "plain")
        reads = ivf_reads(torch, ref, args)
        say(f"ivf_topk nq={nq} nlist={nlist} cap_b={cap_b} d={d} "
            f"nprobe={nprobe} k={k}: max|dscore| {got['max_abs_diff']:.3g}, "
            f"id mismatches {got['id_mismatches']}; {reads['buckets']} "
            f"buckets probed, {reads['items']} work items; modeled bytes "
            f"of rows and ok bytes (from the probes and the ok counts, not "
            f"counted on the card) {reads['per_pair']} a (query, probe) at "
            f"a time, {reads['per_item']} bucket-major")
        if d == DIM and nlist == 16:   # the main path's shapes
            profiles.append((f"nlist={nlist} nprobe={nprobe} cap_b={cap_b}",
                             profiled(nq, nlist, cap_b, d, nprobe, k, lo,
                                      hi)))
            alone = ivf_entry_ms(torch, args)
            say(f"ivf_topk at the main path's nlist=16 nprobe={nprobe} "
                f"cap_b={cap_b}: kernel "
                f"{kernel_ms(lambda: ops.ivf_topk(*args), torch):.4f} ms "
                f"back to back, "
                f"{median_ms(lambda: ops.ivf_topk(*args), torch):.4f} ms in "
                f"single calls; the C entry point alone {alone[0]:.4f} ms "
                f"back to back, {alone[1]:.4f} ms in single calls")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], got["max_abs_diff"])
        worst["id_mismatches"] += got["id_mismatches"]
        if nlist == NLIST:
            deployment = (args, reads)
            profiles.append(("deployment", profiled(nq, nlist, cap_b, d,
                                                    nprobe, k, lo, hi)))

    # ... and across two probed buckets: each query's row of probe rank 0
    # copied into its rank-2 bucket; equal scores, the lower rank first
    for nq, nlist, cap_b, d, nprobe, k in [(70, 16, 64, 32, 8, 128),
                                           (64, 16, 512, 384, 4, 16)]:
        cent, pv, slot, ok = ivf_packed(torch, draw, nlist, cap_b, d, 0,
                                        cap_b)
        pv, q = grid(nlist * cap_b, d), grid(nq, d)
        probes = ref.probe(q, cent, nprobe).long()
        j = torch.arange(nq, device=dev)
        src = probes[:, 0] * cap_b + j % cap_b
        dst = probes[:, 2] * cap_b + (j + 5) % cap_b
        pv[dst] = pv[src]
        ok[src] = ok[dst] = True
        slot = torch.randperm(nlist * cap_b, generator=gen,
                              device=dev).int()
        args = (q, cent, pv, slot, ok, nprobe, k)
        got = ops.ivf_topk(*args)
        check_ties(torch, f"ivf_topk ties across two probed buckets nq={nq} "
                   f"nlist={nlist} nprobe={nprobe} k={k}",
                   ref.ivf_topk(*args), got)

    args, reads = deployment
    q, cent, pv, slot, ok = args[:5]
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
    # the C entry point alone (the probe's selection, the inversion, the
    # scan and the merge; the centroid scores made once), and the plain
    # probe the wrapper no longer runs
    t["kernel_only_ms"], t["kernel_only_call_ms"] = ivf_entry_ms(
        torch, args)
    t["plain_probe_ms"] = kernel_ms(lambda: ref.probe(q, cent, NPROBE), torch)
    records["ivf_topk"] = dict(
        name="ivf_topk", route="cuda", source="src/repro_torch/csrc/ivf_topk.cu",
        replaces="src/repro/kernels/fused_retrieve.py:264",
        jax="src/repro/kernels/fused_retrieve.py:ivf_topk_pallas",
        **errors(worst),
        bound_ms=bms, bound_by=by, **t)
    say(f"ivf_topk at nq={NQ} nlist={NLIST} cap_b={CAP_B} d={DIM} "
        f"nprobe={NPROBE} k={K} ({len(buckets)} distinct buckets probed; "
        f"modeled bytes of rows and ok bytes {reads['per_item']} "
        f"bucket-major, {reads['per_pair']} for a (query, probe) grid; the "
        f"bound counts {n_bytes}): kernel {t['ms']:.4f} ms (the C entry point "
        f"alone {t['kernel_only_ms']:.4f} ms back to back, "
        f"{t['kernel_only_call_ms']:.4f} ms in single calls; the plain "
        f"probe, now selected in the entry point, "
        f"{t['plain_probe_ms']:.4f} ms), plain "
        f"{t['plain_ms']:.4f} ms, gather+bmm+topk {t['library_ms']:.4f} ms, "
        f"bound {bms:.4f} ms ({by}); {speed(t, bms)}")
    return records, profiles


def device_times(torch, fn, calls=20) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel it
    launches, by kernel name (torch.profiler over ``calls`` calls; empty
    where the profiler sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total):
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            out[name[-48:]] = (out.get(name[-48:], 0.0)
                               + e.self_device_time_total / calls)
    return out


def ivf_entry_ms(torch, args):
    """ivf_topk's C entry point alone (the probe's selection, the inversion,
    the bucket scan and the merge) on ``ops.ivf_topk``'s arguments, the
    centroid scores made once: its time back to back and in single
    calls."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_retrieve as tfr

    q, cent, pv, slot, ok, nprobe, k = args
    nq, d = q.shape
    nlist = cent.shape[0]
    dev = q.device
    lib, fn = _build.entry("ivf_topk", 12, 7)
    cscores = (q @ cent.T).contiguous()
    probes = torch.empty((nq, nprobe), dtype=torch.int32, device=dev)
    scratch = torch.empty(tfr._scratch_ints(lib, nq, nprobe, nlist),
                          dtype=torch.int32, device=dev)
    outs = [torch.empty(shape, dtype=dt, device=dev)
            for shape, dt in (((nq, nprobe, k), torch.float32),
                              ((nq, nprobe, k), torch.int32),
                              ((nq, nprobe, k), torch.int32),
                              ((nq, k), torch.float32), ((nq, k), torch.int32))]
    launch = (q.data_ptr(), pv.data_ptr(), slot.data_ptr(),
              ok.view(torch.uint8).data_ptr(), cscores.data_ptr(),
              probes.data_ptr(), scratch.data_ptr(),
              *(o.data_ptr() for o in outs), nq, d, nlist,
              pv.shape[0] // nlist, nprobe, k,
              torch.cuda.get_device_properties(dev).multi_processor_count,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ivf_topk", fn(*launch))
    return kernel_ms(lambda: fn(*launch), torch), median_ms(
        lambda: fn(*launch), torch)


def ivf_reads(torch, ref, args) -> dict:
    """A model of the bytes of packed rows and ok bytes an IVF scan reads
    for these inputs, computed from the probes and the ok counts (no
    counter of the card's): reading each probed bucket's ok rows
    (and its cap_b ok bytes) once per (query, probe) pair, as a (query,
    probe) grid does, or once per work item of up to IVF_QUERIES queries,
    as the bucket-major kernel does; with the distinct buckets and the
    work items."""
    from repro_torch.kernels import fused_retrieve as tfr

    q, cent, pv, _, ok, nprobe, _ = args
    nlist, d = cent.shape
    cap_b = pv.shape[0] // nlist
    per_bucket = ok.view(nlist, cap_b).sum(1) * d * 4 + cap_b
    counts = torch.bincount(ref.probe(q, cent, nprobe).long().reshape(-1),
                            minlength=nlist)
    items = (counts + tfr.IVF_QUERIES - 1) // tfr.IVF_QUERIES
    return {"buckets": int((counts > 0).sum()), "items": int(items.sum()),
            "per_pair": int((counts * per_bucket).sum()),
            "per_item": int((items * per_bucket).sum())}


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

    # -- quant_score: edge cases, then the deployment shapes (every element):
    # bit for bit the limb model on both load paths (cp.async at d 24, 516),
    # with the limbs resident (d <= 384) and streamed (with the integer-add
    # conversion at d 512, the converter above), and within TOL of the plain
    # version
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_retrieve as tfr

    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}
    for nq, n, d in [(3, 100, 32), (1, 5, 8), (65, 1025, 24),
                     (70, 3000, 48), (70, 3000, 512), (70, 3001, 516), (65, 1025, 768),
                     (70, 3000, 1024), (9, 2000, 2052), (NQ, 1 << 18, 768),
                     (NQ, 1 << 18, 1024), (NQ, N, DIM)]:
        q = unit(nq, d)
        codes, scale = sq8(n, d)
        got, want = ops.quant_score(q, codes, scale), ref.quant_score(
            q, codes, scale)
        diff = float((got - want).abs().max())
        exact = torch.equal(got, limb_scores(torch, tfr, q, codes, scale))
        say(f"quant_score nq={nq} N={n} d={d}: max|dscore| {diff:.3g}; "
            f"{'equal to' if exact else 'DIFFERS from'} the limb model")
        if not diff <= TOL or got.shape != want.shape or not exact:
            raise AssertionError(f"quant_score nq={nq} N={n} d={d} "
                                 f"disagrees with plain ({diff}) or the "
                                 f"limb model ({exact})")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], diff)
        del got, want
    t = timings(torch, lambda: ops.quant_score(q, codes, scale),
                lambda: ref.quant_score(q, codes, scale),
                lambda: (q * scale) @ codes.float().T)
    # the C entry point alone (no limb split)
    lib, fn = _build.entry("quant_score", 4, 4, "s8")
    limbs, expo = tfr.sq8_limbs(q * scale[None, :])
    out = torch.empty((NQ, N), device=dev)
    launch = (limbs.data_ptr(), expo.data_ptr(), codes.data_ptr(),
              out.data_ptr(), NQ, N, DIM,
              min(-(-N // _build.tile_rows("quant_score")),
                  torch.cuda.get_device_properties(dev).multi_processor_count),
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "quant_score", fn(*launch))
    t["kernel_only_ms"] = kernel_ms(lambda: fn(*launch), torch)
    t["kernel_only_call_ms"] = median_ms(lambda: fn(*launch), torch)
    del out, limbs
    # bytes: the codes, the query block, the scale, the [nq, N] output;
    # FLOP: one d-long dot product per (query, row)
    # (the products run on the int8 tensor cores: their rate)
    bms, by = bound(N * DIM + NQ * DIM * 4 + DIM * 4 + NQ * N * 4,
                    2.0 * NQ * N * DIM, INT8_OPS_PER_S)
    records["quant_score"] = dict(
        name="quant_score", route="cuda",
        source="src/repro_torch/csrc/quant_score.cu",
        replaces="src/repro/kernels/quant_score.py:40",
        jax="src/repro/kernels/quant_score.py:quant_score_pallas",
        **errors(worst), bound_ms=bms, bound_by=by, **t)
    say(f"quant_score at nq={NQ} N={N} d={DIM}: kernel {t['ms']:.4f} ms "
        f"(the kernel alone {t['kernel_only_ms']:.4f} ms back to back, "
        f"{t['kernel_only_call_ms']:.4f} ms in single calls), plain "
        f"{t['plain_ms']:.4f} ms, (q*scale)@codes.T "
        f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"{speed(t, bms)}")

    # ... and across the tiles one block folds into one list: the wrapper's
    # G blocks (block b takes 64-row tiles b, b + G, ...) over 3G + 1 tiles
    # of exact codes, each query's best row (3 sign(q), the highest score a
    # code row reaches) planted live in tiles G/2, G/2 + G and G/2 + 2G
    # (at d 32, and at 768 and 1,024, where the limbs stream)
    tile = _build.tile_rows("sq8_topk")
    g = torch.cuda.get_device_properties(dev).multi_processor_count
    n, nq, b = 3 * g * tile + 77, tile, g // 2
    for d in (32, 768, 1024):
        codes = torch.randint(-3, 4, (n, d), generator=gen,
                              device=dev).to(torch.int8)
        scale = torch.full((d,), 0.5, device=dev)
        q, live = grid(nq, d), live_mask(n, 0.9)
        j = torch.arange(nq, device=dev)
        planted = torch.stack([b * tile + j, (b + g) * tile + tile - 1 - j,
                               (b + 2 * g) * tile + (j + 10) % tile], 1)
        for col in range(3):
            codes[planted[:, col]] = (3 * torch.sign(q)).to(torch.int8)
        live[planted] = True
        for k in (1, 16, 128):
            got = ops.sq8_topk(q, codes, scale, live, k)
            check_ties(torch, f"sq8_topk ties across a block's tiles (N={n}, "
                       f"d={d}, {g} lists) k={k}",
                       ref.sq8_topk(q, codes, scale, live, k), got)
            if not torch.equal(got[1][:, :3], planted[:, :k].int()):
                raise AssertionError(f"sq8_topk d={d} k={k}: the planted "
                                     f"best rows do not lead")

    def limb_model(q, codes, scale, live, k):
        """The kernel's own arithmetic in torch: its result bit for bit."""
        return ref.masked_topk(tfr.sq8_limb_scores(
            *tfr.sq8_limbs(q * scale[None, :]), codes), live, k)

    # both load paths (cp.async at d % 16 != 0, TMA at d % 16 == 0), the
    # limbs resident (d <= 384) and streamed (768, 1,024, 2,052), two query
    # blocks, 2-3 tiles a list: bit for bit the limb model, and the plain
    # version under the parity rule
    for d in (24, 384, 768, 1024, 2052):
        q, live = unit(70, d), live_mask(20000, 0.9)
        codes, scale = sq8(20000, d)
        for k in (1, 16, 128):
            got = ops.sq8_topk(q, codes, scale, live, k)
            want = limb_model(q, codes, scale, live, k)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"sq8_topk d={d} k={k} differs from "
                                     f"the limb model")
            check(f"sq8_topk d={d} k={k}", compare_topk(
                *ref.sq8_topk(q, codes, scale, live, k), *got), "plain")
        say(f"sq8_topk at d={d} ({'TMA' if d % 16 == 0 else 'cp.async'} "
            f"loads), nq=70, N=20000, k=1/16/128: equal to the limb model "
            f"bit for bit")

    # -- sq8_topk: edge cases, then the deployment shapes
    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}
    for nq, n, d, k, p in [(3, 32, 8, 8, 1.0), (2, 64, 8, 6, 0.05),
                           (1, 5, 8, 8, 1.0), (1, 129, 24, 4, 0.0),
                           (7, 1000, 64, 5, 0.8), (5, 4101, 48, 16, 0.8),
                           (70, 3000, 32, 128, 0.9),
                           (NQ, N, DIM, K, 0.99)]:
        q, live = unit(nq, d), live_mask(n, p)
        codes, scale = sq8(n, d)
        out = ops.sq8_topk(q, codes, scale, live, k)
        got = check(f"sq8_topk nq={nq} N={n} d={d} k={k}",
                    compare_topk(*ref.sq8_topk(q, codes, scale, live, k),
                                 *out), "plain")
        if n < N:
            want = limb_model(q, codes, scale, live, k)
            if not (torch.equal(out[0], want[0])
                    and torch.equal(out[1], want[1])):
                raise AssertionError(f"sq8_topk nq={nq} N={n} d={d} k={k} "
                                     f"differs from the limb model")
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
    # scale, the outputs; operations: one d-long dot product per (query,
    # live row), at the int8 tensor cores' rate
    bms, by = bound(n_live * DIM + N + NQ * DIM * 4 + DIM * 4 + NQ * K * 8,
                    2.0 * NQ * n_live * DIM, INT8_OPS_PER_S)
    # the C entry point alone (the scan and its merge, no limb split): at
    # k=K and at k=1 (the same loads and products, few candidates)
    lib, fn = _build.entry("sq8_topk", 8, 5, "s8")
    limbs, expo = tfr.sq8_limbs(q * scale[None, :])
    n_lists = min(-(-N // tile), g)

    def alone(k):
        out_s = torch.empty((NQ, n_lists, k), device=dev)
        out_i = torch.empty((NQ, n_lists, k), dtype=torch.int32, device=dev)
        top_s = torch.empty((NQ, k), device=dev)
        top_i = torch.empty((NQ, k), dtype=torch.int32, device=dev)
        launch = (limbs.data_ptr(), expo.data_ptr(), codes.data_ptr(),
                  live.view(torch.uint8).data_ptr(), out_s.data_ptr(),
                  out_i.data_ptr(), top_s.data_ptr(), top_i.data_ptr(), NQ,
                  N, DIM, k, n_lists,
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "sq8_topk", fn(*launch))
        return kernel_ms(lambda: fn(*launch), torch)

    t["kernel_only_ms"] = alone(K)
    t["kernel_only_k1_ms"] = alone(1)
    records["sq8_topk"] = dict(
        name="sq8_topk", route="cuda", source="src/repro_torch/csrc/sq8_topk.cu",
        replaces="src/repro/kernels/fused_retrieve.py:122",
        jax="src/repro/kernels/fused_retrieve.py:sq8_topk_pallas",
        **errors(worst), bound_ms=bms, bound_by=by, **t)
    say(f"sq8_topk at nq={NQ} N={N} d={DIM} k={K} ({n_live} live): kernel "
        f"{t['ms']:.4f} ms (the kernel alone {t['kernel_only_ms']:.4f} ms, "
        f"at k=1 {t['kernel_only_k1_ms']:.4f} ms), plain "
        f"{t['plain_ms']:.4f} ms, torch.topk {t['library_ms']:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); {speed(t, bms)}")
    del q, codes, scale, live
    # ... and at Fig. 11's 768 and public embedders' 1,024, where the limbs
    # stream with the codes: against the plain version, with the time and
    # the bound
    records["sq8_topk"]["wide"] = {}
    for d in (768, 1024):
        q, live = unit(NQ, d), live_mask(N, 0.99)
        codes, scale = sq8(N, d)
        check(f"sq8_topk nq={NQ} N={N} d={d} k={K}", compare_topk(
            *ref.sq8_topk(q, codes, scale, live, K),
            *ops.sq8_topk(q, codes, scale, live, K)), "plain")
        n_live = int(live.sum())
        wb, wby = bound(n_live * d + N + NQ * d * 4 + d * 4 + NQ * K * 8,
                        2.0 * NQ * n_live * d, INT8_OPS_PER_S)
        tw = {"ms": kernel_ms(lambda: ops.sq8_topk(q, codes, scale, live, K),
                              torch),
              "call_ms": median_ms(
                  lambda: ops.sq8_topk(q, codes, scale, live, K), torch),
              "bound_ms": wb, "bound_by": wby}
        records["sq8_topk"]["wide"][d] = tw
        say(f"sq8_topk at nq={NQ} N={N} d={d} k={K} ({n_live} live; limbs "
            f"streamed): equal to the plain version under the parity rule; "
            f"kernel {tw['ms']:.4f} ms back to back, {tw['call_ms']:.4f} ms "
            f"in single calls, bound {wb:.4f} ms ({wby}), "
            f"{100 * wb / tw['ms']:.1f} % of it")
        del q, codes, scale, live
    torch.cuda.empty_cache()

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
                              device=dev, dtype=torch.uint8)
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

    # ... and across two buckets of one probe group: for each query, the
    # codes of a row of its probe rank 1 copied into a row of its rank 3
    # (both in the first group of 4); equal scores, the lower rank first.
    # k covers every probed row
    nq, nlist, cap_b, d, m, nprobe, k = 6, 16, 16, 48, 48, 8, 128
    cent, codebook, codes, slot, ok = packed(nlist, cap_b, d, m, 0, cap_b)
    q = unit(nq, d)
    probes = ref.probe(q, cent, nprobe).long()
    src = probes[:, 1] * cap_b + torch.arange(nq, device=dev)
    dst = probes[:, 3] * cap_b + 8 + torch.arange(nq, device=dev)
    codes[dst] = codes[src]
    ok[src] = ok[dst] = True
    slot[src] = torch.where(slot[src] < 0, 10**6 + src.int(), slot[src])
    slot[dst] = torch.where(slot[dst] < 0, 2 * 10**6 + dst.int(), slot[dst])
    args = (q, codebook, cent, codes, slot, ok, nprobe, k)
    got = ops.pq_topk(*args)
    check_ties(torch, f"pq_topk ties across two buckets of one probe group "
               f"(nq={nq}, nprobe={nprobe}, group {tfr.PQ_GROUP}) k={k}",
               ref.pq_topk(*args), got)
    for i in range(nq):
        row = got[1][i].tolist()
        a, b = row.index(int(slot[src[i]])), row.index(int(slot[dst[i]]))
        if not (a < b and got[0][i, a] == got[0][i, b]):
            raise AssertionError(f"pq_topk query {i}: the tie across probe "
                                 f"ranks 1 and 3 is out of order")

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
    # the reference's int32 codes, narrowed by the wrapper: the same ids
    # and scores as the uint8 mirror
    got, want = ops.pq_topk(*args[:3], codes.int(), *args[4:]), ops.pq_topk(
        *args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("pq_topk: int32 codes differ from the uint8 "
                             "mirror")
    say(f"pq_topk at nq={NQ} nlist={NLIST} cap_b={CAP_B} m={PQ_M}: int32 "
        f"codes give the uint8 mirror's ids and scores")
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
    # the C entry point alone (the scan and its merge), its wrapper's probe
    # and tables made once; and on the same buckets with every row's codes
    # equal (each warp's 32 lookups of a subspace then read one word: no
    # bank conflicts), which shows what the conflicts of the real codes cost
    lib, fn = _build.entry("pq_topk", 10, 6, "u8")
    lut = ref.pq_lut(q, codebook).contiguous()
    probes = ref.probe(q, cent, NPROBE)
    groups = -(-NPROBE // tfr.PQ_GROUP)
    out_s = torch.empty((NQ, groups, K), device=dev)
    out_i = torch.empty((NQ, groups, K), dtype=torch.int32, device=dev)
    out_p = torch.empty((NQ, groups, K), dtype=torch.int32, device=dev)
    top_s = torch.empty((NQ, K), device=dev)
    top_i = torch.empty((NQ, K), dtype=torch.int32, device=dev)

    def alone(codes):
        launch = [lut.data_ptr(), codes.data_ptr(), slot.data_ptr(),
                  ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
                  out_s.data_ptr(), out_i.data_ptr(), out_p.data_ptr(),
                  top_s.data_ptr(), top_i.data_ptr(), NQ, PQ_M, CAP_B, NPROBE,
                  tfr.PQ_GROUP, K, torch.cuda.current_stream(dev).cuda_stream]
        _build.check(lib, "pq_topk", fn(*launch))
        return kernel_ms(lambda: fn(*launch), torch)

    t["kernel_only_ms"] = alone(codes)
    t["kernel_only_same_codes_ms"] = alone(
        codes[:1].expand_as(codes).contiguous())
    # bytes: every probed bucket's ok bytes and its ok rows' codes (one byte
    # each) once, the slot ids of the rows a (query, probe) emits, the query
    # block, the centroids, the codebook, the outputs; operations: m table
    # adds per (query, probed ok row), the probe's centroid scores and the
    # tables
    probe = ref.probe(q, cent, NPROBE).long()
    ok_rows = ok2.sum(1)
    buckets = torch.unique(probe)
    n_bytes = (int(ok_rows[buckets].sum()) * PQ_M + len(buckets) * CAP_B
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
        f"{t['ms']:.4f} ms (the kernel alone {t['kernel_only_ms']:.4f} ms, "
        f"with every row's codes equal {t['kernel_only_same_codes_ms']:.4f} "
        f"ms), plain {t['plain_ms']:.4f} ms, "
        f"gather+sum+topk {t['library_ms']:.4f} ms, bound {bms:.4f} ms "
        f"({by}); {speed(t, bms)}")
    return records


def make_rows(torch, n=N, dim=DIM, n_fresh=N_FRESH, capacity=DB_CAPACITY,
              flat_capacity=FLAT_CAPACITY):
    """One seeded row set for the DB phases: n clustered unit rows of width
    dim, n_fresh fresh rows, the removed documents (1% of them; row s
    belongs to document s // 4) and 20 batches of NQ queries near surviving
    rows; with the DB's capacities."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    centers = torch.nn.functional.normalize(
        torch.randn(4096, dim, generator=gen, device=dev), dim=1)
    pick = torch.randint(4096, (n + n_fresh,), generator=gen, device=dev)
    rows = torch.nn.functional.normalize(
        centers[pick] + 0.6 * torch.nn.functional.normalize(
            torch.randn(n + n_fresh, dim, generator=gen, device=dev), dim=1),
        dim=1)
    n_docs = (n + n_fresh) // 4
    gone = torch.randperm(n_docs, generator=torch.Generator().manual_seed(2))[
        :n_docs // 100]
    live = torch.ones(n + n_fresh, dtype=torch.bool, device=dev)
    live[(gone[:, None] * 4 + torch.arange(4)).reshape(-1).to(dev)] = False
    picks = torch.nonzero(live)[:, 0]
    batches = []
    for _ in range(20):
        at = picks[torch.randint(len(picks), (NQ,), generator=gen, device=dev)]
        batches.append(torch.nn.functional.normalize(
            rows[at] + 0.1 * torch.randn(NQ, dim, generator=gen, device=dev),
            dim=1))
    return {"rows": rows, "gone": gone.tolist(), "batches": batches, "n": n,
            "dim": dim, "n_fresh": n_fresh, "capacity": capacity,
            "flat_capacity": flat_capacity}


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
    n, n_fresh = data["n"], data["n_fresh"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    db = TorchVectorDB(DBConfig(dim=data["dim"], capacity=data["capacity"],
                                flat_capacity=data["flat_capacity"], **cfg),
                       device=DEVICE)
    t0 = time.perf_counter()
    step = min(1 << 17, n)
    for lo in range(0, n, step):
        db.insert(rows[lo:lo + step], [Chunk(-1, (lo + i) // 4, "")
                                       for i in range(step)])
    t1 = time.perf_counter()
    db.build_index()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # a flat index counts as built from the start, so its bulk inserts
    # already fold the buffer in; what matters is that the fresh rows stay
    rebuilds = db.counters["rebuilds"]
    db.insert(rows[n:], [Chunk(-1, (n + i) // 4, "") for i in range(n_fresh)])
    removed = sum(db.remove(d) for d in data["gone"])
    st = db.stats()
    fill = (f" (max bucket fill {int(db.bucket_live.sum(1).max())} of "
            f"{CAP_B})" if db.bucket_live is not None else "")
    if db.packed is not None and "codes" in db.packed:
        pc = db.packed["codes"]
        fill += (f"; packed PQ mirror {pc.dtype} {tuple(pc.shape)}, "
                 f"{pc.numel() * pc.element_size()} bytes")
    say(f"{name}: inserted {n} rows of width {data['dim']} in "
        f"{t1 - t0:.1f} s, build_index {t2 - t1:.1f} s{fill}, {n_fresh} "
        f"fresh rows, {removed} rows of "
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
    the next, then a flat + SQ8 DB at d 768; returns each kernel's launches
    in the DB run that drives it."""
    from repro_torch.kernels import topk_search as tts

    data = make_rows(torch)

    def packed_ok(db, main_live):
        slot = db.packed["slot"]
        return slot, (slot >= 0) & main_live[slot.clamp(min=0)]

    def ivf_kernels(db, q, main_live):
        slot, ok = packed_ok(db, main_live)
        return {"ivf_topk": lambda: ops.ivf_topk(
            q, db.centroids, db.packed["vecs"], slot, ok, NPROBE, K)}

    def sq8_kernels(db, q, main_live):
        scores = ops.quant_score(q, db.sq_codes, db.sq_scale)
        key = tts._row_key(scores, torch.arange(
            scores.shape[1], device=scores.device)[None, :])
        return {"sq8_topk": lambda: ops.sq8_topk(
                    q, db.sq_codes, db.sq_scale, main_live, K),
                "select_by_row alone": lambda: tts.select_by_row(
                    scores, main_live, K),
                "its torch.topk of the keys alone": lambda: torch.topk(
                    key, K, dim=1),
                "quant_score": lambda: ops.quant_score(
                    q, db.sq_codes, db.sq_scale),
                "quant_score + select_by_row (the op rung)": lambda:
                    tts.select_by_row(ops.quant_score(
                        q, db.sq_codes, db.sq_scale), main_live, K)}

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
    del data
    torch.cuda.empty_cache()

    # Fig. 11's widest embedding (768) on flat + SQ8, at a quarter of the
    # rows: sq8_topk and quant_score with the limbs streamed
    t0 = time.perf_counter()
    wide = make_rows(torch, n=1 << 18, dim=768, n_fresh=8192,
                     capacity=(1 << 18) + 16384, flat_capacity=16384)
    run_db(torch, ops, ref, compare_topk, wide, "db flat+sq8 d=768", dict(
        index_type="flat", quant="sq8", use_kernel="fused"),
        {"fused": ("sq8_topk", "topk_search"),
         "op": ("quant_score", "topk_search")}, sq8_kernels, off_chunk=NQ)
    say(f"db flat+sq8 d=768: phase {time.perf_counter() - t0:.1f} s")
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



# the serving phase: scenario sims card vs CPU on the fused DB, live
# scenarios, the full-width model under closed/open/elastic load, and the
# pipelined executor
SCENARIO_DB = "torch_fused"          # ivf_topk + the freshness topk_search
LIVE_SCENARIOS = ("steady", "update_storm", "replica_failure")
# quality of a sim on the card against the CPU: equal where every request's
# retrieval agrees; each request whose ids differ inside a near tie may move
# a mean quality metric by at most 1/n_queries
SIM_QUALITY_TOL = 1e-9
MODEL_REQUESTS = 48
# the model runs' latency SLO: an interactive answer of 16 tokens from an
# 8B generator (TTFT ~0.11 s, 15 decode steps of 40-70 ms at batch 8)
MODEL_SLO_MS = 2000.0
ELASTIC_MEM_SLACK_GIB = 2.0          # a second KV cache is ~0.52 GiB


def fused_scenario(name):
    """The registered scenario at ``golden_variant`` scale, on the fused
    DB (its other pipeline overrides, such as replicas, kept)."""
    from repro_torch.scenarios import golden_variant

    spec = golden_variant(name)
    pipe = json.loads(json.dumps(spec.pipeline))
    pipe.setdefault("vectordb", {})["component"] = SCENARIO_DB
    return spec.replace(pipeline=pipe)


class RetrievalLog:
    """Records every retrieval stage's per-request ``(ids, scores)`` in
    call order while active (the traces keep the ids, not the scores the
    near-tie rule needs)."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from repro_torch.core.stages import RetrieveStage

        self._orig = orig = RetrieveStage._apply
        rows = self.rows

        def apply(stage, batch):
            orig(stage, batch)
            rows.extend((r.chunk_ids.copy(), r.scores.copy())
                        for r in batch.results)

        RetrieveStage._apply = apply
        return self

    def __exit__(self, *exc):
        from repro_torch.core.stages import RetrieveStage

        RetrieveStage._apply = self._orig
        return False


def same_outputs(what, want_rows, want_answers, rows, answers):
    """Hold one run's per-request retrieval and answers against another's:
    ids by the near-tie rule of ``kernels.parity``, answers equal wherever
    the ids are. Returns the rows whose ids differ."""
    import numpy as np

    from repro_torch.kernels.parity import compare_topk

    if len(rows) != len(want_rows) or len(answers) != len(want_answers):
        raise AssertionError(f"{what}: {len(rows)} retrievals and "
                             f"{len(answers)} answers, want "
                             f"{len(want_rows)} and {len(want_answers)}")
    ids, want_ids = (np.stack([r[0] for r in x]) for x in (rows, want_rows))
    res = compare_topk(np.stack([r[1] for r in want_rows]), want_ids,
                       np.stack([r[1] for r in rows]), ids)
    differ = [i for i in range(len(ids))
              if not np.array_equal(ids[i], want_ids[i])]
    bad = [i for i in range(len(answers)) if i not in differ
           and answers[i] != want_answers[i]]
    if res["violations"] or bad:
        raise AssertionError(f"{what}: {res}, answers differ at {bad}")
    return differ


def sim_parity(torch, ops, device, ref_device="cpu"):
    """Every scenario but shard_scale simulated on ``device`` and on
    ``ref_device``: the timing fields and event streams equal, requests
    equal by the near-tie rule, quality within its tolerance."""
    from repro_torch.scenarios import ScenarioRunner, scenario_names

    out = {}
    for name in scenario_names():
        if name == "shard_scale":    # the sharded DB is not ported
            continue
        spec = fused_scenario(name)
        runs = {}
        for dev in (device, ref_device):
            ops.reset_launch_counts()
            runner = ScenarioRunner(spec, device=dev)
            with RetrievalLog() as log:
                report = runner.simulate()
            runs[dev] = (report, log.rows,
                         [t.answer for t in runner.pipeline.traces],
                         ops.launch_counts())
        (got, rows, answers, launches), (want, want_rows, want_answers, _) = \
            runs[device], runs[ref_device]
        quality_keys = ("quality_weight_mean", "quality_goodput_qps")
        for key in ("scaling_events", "knob_timeline", "fault_events",
                    "stage_report", "trace_decomposition"):
            if getattr(got, key) != getattr(want, key):
                raise AssertionError(f"sim {name}: {key} differs on "
                                     f"{device}")
        timing = {k: v for k, v in want.summary.items()
                  if k not in quality_keys}
        if {k: got.summary.get(k) for k in timing} != timing:
            raise AssertionError(f"sim {name}: summary timing differs: "
                                 f"{got.summary} vs {want.summary}")
        differ = same_outputs(f"sim {name}", want_rows, want_answers, rows,
                              answers)
        n = max(len(answers), 1)
        tol = SIM_QUALITY_TOL + len(differ) / n
        worst = max([abs(got.quality[k] - v)
                     for k, v in want.quality.items()]
                    + [abs(got.summary[k] - want.summary[k])
                       for k in quality_keys if k in want.summary])
        if set(got.quality) != set(want.quality) or not worst <= tol:
            raise AssertionError(f"sim {name}: quality {got.quality} vs "
                                 f"{want.quality} (tolerance {tol})")
        if device != "cpu" and launches["ivf_topk"] == 0:
            raise AssertionError(f"sim {name} on {device}: launches "
                                 f"{launches}")
        out[name] = launches
        say(f"sim {name} ({len(answers)} queries, "
            f"{int(want.summary['n_mutations'])} mutations, "
            f"{len(want.scaling_events)} scale events): {device} = "
            f"{ref_device} on timing and events; {len(differ)} requests' "
            f"ids differ inside near ties; quality max|d| {worst:.3g} "
            f"(tolerance {tol:.3g}); launches {launches}")
    return out


def live_scenarios(torch, ops, device):
    """``ScenarioRunner.serve()`` of the live scenarios on the fused DB:
    every request answered, except the injected kills' in
    replica_failure; the kernels launched."""
    from repro_torch.scenarios import ScenarioRunner
    from repro_torch.scenarios import runner as scenario_runner
    from repro_torch.serving.elastic import ReplicaKilled
    from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
    from repro_torch.workload.generator import WorkloadGenerator

    harness = scenario_runner.ServingHarness
    for name in LIVE_SCENARIOS:
        spec = fused_scenario(name)
        n_stream = len(list(WorkloadGenerator(
            spec.workload_config(), SyntheticCorpus(CorpusConfig(
                n_docs=spec.n_docs, seed=spec.seed))).requests()))
        errors = []
        orig = harness._finish

        def finish(self, sub, ok, err=None, _orig=orig):
            if not ok:
                errors.append(err)
            return _orig(self, sub, ok, err)

        harness._finish = finish
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            report = ScenarioRunner(spec, device=device).serve()
        finally:
            harness._finish = orig
        launches = ops.launch_counts()
        s = report.summary
        injected = sum(e["action"] == "inject" for e in report.fault_events)
        allowed = name == "replica_failure"
        if (s["n_requests"] + s["n_failed"] != n_stream
                or (errors and not allowed)
                or not all(isinstance(e, ReplicaKilled) for e in errors)
                or launches["ivf_topk"] == 0
                or (s.get("n_mutations", 0) and launches["topk_search"] == 0)):
            raise AssertionError(f"live {name}: {s}, errors {errors[:3]}, "
                                 f"launches {launches}")
        say(f"live {name} ({time.perf_counter() - t0:.1f} s): "
            f"{int(s['n_queries'])} queries, "
            f"{int(s.get('n_mutations', 0))} mutations, "
            f"{int(s['n_failed'])} failed (by {injected} injected kills), "
            f"latency p50/p95/p99 {s['p50_latency_ms']:.2f} / "
            f"{s['p95_latency_ms']:.2f} / {s['p99_latency_ms']:.2f} ms, "
            f"SLO {spec.slo_ms:.0f} ms attainment "
            f"{s['slo_attainment']:.3f}, goodput {s['goodput_qps']:.2f} QPS "
            f"(quality-aware {s['quality_goodput_qps']:.2f}); "
            f"{len(report.scaling_events)} scale events; launches "
            f"{launches}")


def model_under_load(torch, ops, device, spec_path, n_requests, trace_path):
    """The model spec served closed-loop at concurrency 8 (its rate R),
    open-loop Poisson at 0.5 R and 0.9 R, and elastic at 0.9 R with up to
    2 replicas and a trace; returns each run's document."""
    import gc

    from repro_torch.launch import serve
    from repro_torch.obs.export import validate_chrome_trace

    base = ["--config", str(spec_path), "--device", device, "--docs", "256",
            "--requests", str(n_requests), "--batch", "8", "--slo-ms",
            str(MODEL_SLO_MS)]
    runs = [("closed", ["--mode", "closed", "--concurrency", "8"])]
    docs = {}
    while runs:
        name, flags = runs.pop(0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        doc = serve.main(base + flags)
        wall = time.perf_counter() - t0
        doc["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches = ops.launch_counts()
        s, gen = doc["summary"], doc["gen"]
        if (s["n_failed"] or sum(doc["ops"].values()) != n_requests
                or min(launches["flash_attention"], launches["ivf_topk"],
                       launches["topk_search"]) == 0):
            raise AssertionError(f"model {name}: {s}, ops {doc['ops']}, "
                                 f"launches {launches}")
        docs[name] = doc
        say(f"model {name} ({' '.join(flags)}; {wall:.1f} s): "
            f"{int(s['n_queries'])} queries at {s['achieved_qps']:.3f} QPS"
            + (f" (offered {s['offered_qps']:.3f})" if "offered_qps" in s
               else "")
            + f", latency "
            f"p50/p95/p99 {s['p50_latency_ms']:.1f} / "
            f"{s['p95_latency_ms']:.1f} / {s['p99_latency_ms']:.1f} ms, "
            f"TTFT p50 {1e3 * gen['ttft_p50_s']:.2f} ms, TPOT p50 "
            f"{1e3 * gen['tpot_p50_s']:.2f} ms, goodput "
            f"{s.get('goodput_qps', 0.0):.3f} QPS (SLO "
            f"{s.get('slo_ms', 0.0):.0f} ms), "
            + (f"mean batch {s['mean_batch_size']:.2f}, "
               if "mean_batch_size" in s else "")
            + f"{len(doc.get('scaling_events', []))} scale events "
            f"{doc.get('scaling_events', [])}; max_memory_allocated "
            f"{doc['peak_gib']:.2f} GiB; launches {launches}")
        if name == "closed":
            rate = s["achieved_qps"]
            for share in (0.5, 0.9):
                runs.append((f"open {share} R",
                             ["--mode", "open", "--arrival", "poisson",
                              "--target-qps", f"{share * rate:.4f}"]))
            runs.append(("elastic 0.9 R",
                         ["--mode", "open", "--elastic", "--max-replicas",
                          "2", "--target-qps", f"{0.9 * rate:.4f}",
                          "--trace-out", str(trace_path)]))
    peak = docs["elastic 0.9 R"]["peak_gib"]
    if peak > docs["closed"]["peak_gib"] + ELASTIC_MEM_SLACK_GIB:
        raise AssertionError(f"elastic peak {peak:.2f} GiB exceeds the "
                             f"closed run's {docs['closed']['peak_gib']:.2f}"
                             f" + {ELASTIC_MEM_SLACK_GIB} GiB")
    with open(trace_path) as f:
        trace = json.load(f)
    errs = validate_chrome_trace(trace)
    if errs:
        raise AssertionError(f"trace {trace_path}: {errs[:5]}")
    say(f"elastic trace: {len(trace['traceEvents'])} events, valid; peak "
        f"{peak:.2f} GiB against the closed run's "
        f"{docs['closed']['peak_gib']:.2f} GiB")
    return docs


def stage_pipeline(torch, ops, device, spec_path):
    """``--stage-pipeline`` on the fused IVF spec (per-stage occupancy),
    then the same query stream lock-step and pipelined on one indexed
    pipeline: the same outputs."""
    from repro_torch.core.registry import build
    from repro_torch.core.spec import PipelineSpec
    from repro_torch.launch import serve
    from repro_torch.serving.staged import StagedExecutor
    from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
    from repro_torch.workload.generator import (WorkloadConfig,
                                                WorkloadGenerator)

    ops.reset_launch_counts()
    doc = serve.main(["--config", str(spec_path), "--device", device,
                      "--mode", "sync", "--stage-pipeline", "--docs", "256",
                      "--requests", "64"])
    rows = doc["stage_pipeline"]["report"]
    n = rows[0]["n_items"]
    if (n == 0 or any(r["n_items"] != n or not 0 < r["occupancy"] <= 1
                      for r in rows)
            or ops.launch_counts()["ivf_topk"] == 0):
        raise AssertionError(f"stage pipeline: {rows}")
    pipe = build(PipelineSpec.from_file(spec_path), device=device)
    corpus = SyntheticCorpus(CorpusConfig(n_docs=256))
    pipe.index_documents(corpus.all_documents())
    reqs = [r for r in WorkloadGenerator(WorkloadConfig(
        query_frac=1.0, update_frac=0.0, n_requests=64), corpus).requests()]
    qs = [r.question for r in reqs]
    with RetrievalLog() as want_log:
        want = [t.answer for lo in range(0, len(qs), 8)
                for t in pipe.query(qs[lo:lo + 8])]
    with RetrievalLog() as log:
        got = [t.answer for t in StagedExecutor(pipe, default_batch=8)
               .run(qs).traces]
    differ = same_outputs("staged vs lock-step", want_log.rows, want,
                          log.rows, got)
    say(f"stage pipeline ({spec_path.name}, {int(n)} queries): occupancy "
        + ", ".join(f"{r['stage']} {r['occupancy']:.3f} (busy "
                    f"{r['busy_s']:.3f} s, mean batch {r['mean_batch']:.1f})"
                    for r in rows)
        + f"; {len(qs)} queries staged = lock-step ({len(differ)} requests' "
          f"ids differ inside near ties)")


def phase_serving(torch, ops):
    """The serving layer on the card (see the module docstring, phase 9)."""
    specs = SRC / "repro_torch" / "specs"
    t0 = time.perf_counter()
    sim_parity(torch, ops, DEVICE)
    say(f"serving: sims {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    live_scenarios(torch, ops, DEVICE)
    say(f"serving: live scenarios {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    model_under_load(torch, ops, DEVICE, specs / "model_llama3_8b.json",
                     MODEL_REQUESTS, ROOT / "build" / "serving_trace.json")
    say(f"serving: model under load {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stage_pipeline(torch, ops, DEVICE, specs / "fused_ivf.json")
    say(f"serving: stage pipeline {time.perf_counter() - t0:.1f} s")


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
    widths = {"topk_search": [DIM], "ivf_topk": [DIM],
              "quant_score": [DIM, 768, 1024],
              "sq8_topk": [DIM, 768, 1024], "pq_topk": [PQ_M],
              "flash_attention": [128, 64]}
    for name, log in reports.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            if "registers" in line or "spill" in line:
                say(f"  {name}: {entry}: {line.strip()}")
        say(f"  {name}: shared memory per block " + ", ".join(
            f"{_build.smem_bytes(name, d, K)} bytes at width {d}"
            for d in widths[name]))

    timings = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    records, profiles = phase_kernels(torch, ops, ref, compare_topk)
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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serving(torch, ops)
    timings["serving"] = time.perf_counter() - t0
    # ivf_topk by kernel, once every timing is taken (the profiler's
    # tracing stays on the host's launch path after it ends)
    torch.cuda.empty_cache()
    records["ivf_topk"]["device_us"] = {}
    for shape, make_call in profiles:
        us = device_times(torch, make_call())
        records["ivf_topk"]["device_us"][shape] = us
        say(f"ivf_topk at the {shape} shape, device time a call by kernel "
            f"(torch.profiler): " + ", ".join(
                f"{k} {v:.2f} us" for k, v in us.items()))
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
