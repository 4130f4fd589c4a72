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
   medians of RUNS, 10: around 10 back-to-back calls and around single
   calls),
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
5. sharded: the IVF1024 DB's rows over 4 shards (``ShardedVectorDB``,
   417,792 slots, nlist 256 and flat 16,384 a shard, fused: each shard's
   ivf_topk and freshness topk_search), 20 batches through ``search()``
   with recall@16, merge time, shard imbalance and peak memory beside the
   unsharded IVF1024 DB's, fused equal to ``off``; at 262,144 rows a flat
   4-shard DB against the exact global top-k, a 1-shard DB against a bare
   ``TorchVectorDB`` on one state (bit for bit), flat + SQ8 and IVF + PQ
   4-shard DBs fused against ``off`` (sq8_topk, pq_topk); ``shard_scale``
   simulated on the card and on the CPU (equal) and served live;
6. serve: ``repro_torch.launch.serve`` on each vector-DB spec of
   ``src/repro_torch/specs`` must answer its requests through its kernels
   with a quality report;
7. flash_attention against its plain version: the reference's test shapes,
   edge shapes (S 1, 63, 65, 192; GQA groups of 1, 3, 4; causal or not;
   bf16 and fp32), the exact first causal row, and the three deployment
   shapes (the Llama-3-8B prefill at S 512 and a ragged 500, the
   Qwen3-30B-A3B prefill at GQA group 8, the embedder, the
   cross-encoder), each also held to a worst-row relative
   error that a planted fault (one K/V tile dropped) exceeds, with the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   times and the bound;
8. the model at smoke size: one set of seeded weights on the card and on
   the CPU (the llama3 smoke config in fp32, then in bf16 through the bf16
   mma kernel); prefill logits and 8 greedy tokens must agree;
9. the model at full width: Llama-3-8B (8,030,261,248 parameters) built on
   the card from a seed, then ``repro_torch.launch.serve`` with
   ``model_llama3_8b.json`` (transformer embedder, fused IVF DB,
   cross-encoder, ModelLLM) over MODEL_REQUESTS (24) requests, which must
   answer every request with
   ``flash_attention`` launched once per layer of every prefill, embedder
   and cross-encoder batch;
10. serving: every registered scenario but ``shard_scale`` (phase 5)
   simulated at its ``golden_variant`` size on the fused DB
   (``ivf_topk`` and the freshness ``topk_search``) on the card and on the
   CPU: timing fields, scale events, knob timeline and fault events equal,
   every request's ids equal by the near-tie rule and its answer equal
   where they are, quality within SIM_QUALITY_TOL; ``steady``,
   ``update_storm`` and ``replica_failure`` served live on the card (every
   request answered but the injected kills'); ``model_llama3_8b.json``
   served closed-loop at concurrency 8 (its rate R), open-loop Poisson at
   0.9 R, and elastic at 0.9 R with up to 2 replicas, each over
   MODEL_LOAD_REQUESTS (16) requests, the elastic one with a
   Chrome trace under ``build/`` (no failed request, the kernels launched,
   the elastic run's peak memory at most the closed run's + 2 GiB); and
   ``--stage-pipeline`` on ``fused_ivf.json``, whose pipelined outputs
   must equal the lock-step ones;
11. limits: every DB kernel at k 129, 500 and 1,024 (the large-k path of
   ``csrc/topk_large.cu``) and at row widths 3, 130 and 383 (zero-padded
   to a multiple of 4), also with fewer live rows than k, against its plain
   version (tie order bit for bit on exact-arithmetic rows); pq_topk with
   a 256-subspace table (past shared memory); flash_attention at head dims
   24, 80, 96 and 200 (zero-padded, the true dh's scale); then the times at
   the main path's shapes: each DB kernel at k 500 beside k 16, at width
   383 beside 384, pq_topk's 256-subspace table, flash_attention at the
   Llama-3-8B prefill at each head dim beside 128;
12. engine: Llama-3-8B (random bf16 weights from seed 0) generating for
   8 RAG prompts (ENGINE_PROMPTS; 16 before phase 18 came) of 16 to 512
   tokens lock-step (``ModelLLM``, batch 8) and through ``GenEngine`` at (slots 8, chunk 128, budget 4, fcfs) and
   (slots 3, chunk 32, budget 1, sjf): greedy tokens equal but for rows
   whose first difference is a near tie of the lock-step logits; then
   ``model_llama3_8b_engine.json`` served as phase 10 serves the lock-step
   spec (closed at concurrency 8, open at 0.9 R of its own R,
   elastic at 0.9 R with a trace that must hold the engine's ``gen.*``
   instants), every query generated and counted once, with the engine's
   decode steps, prefill chunks and mean active slots; phase 18 (e) runs
   between the two on the same weights;
13. moe: Qwen3-30B-A3B (30,532,110,336 random bf16 parameters from seed 0)
   built on the card, its counts, bytes and model FLOPs against the
   reference's, ``time_model`` (prefill and decode step against their
   bounds, the experts a step routes to, launches and idle share), the
   served model's engine beside lock-step on 8 prompts (its drops
   counted, not held), the engine held to lock-step at full width without
   drops (fp32, 4 layers), then ``model_qwen3_moe_30b_a3b.json`` served
   lock-step (flash_attention in every prefill layer) and closed at
   concurrency 8;
14. zoo: flash_attention with a sliding window against its plain version
   (every combination of window 1, 17, 64 and 4,096, S 63, 65 and 1,000,
   GQA groups 1, 4 and 8, causal or not, and the wgmma kernel at dh 64,
   128 and 80 padded, mma.sync at dh 32 and the fp32 kernel, held
   elementwise and by the worst row), then Zamba2's shared block (B 1, H 32, S 6,144, dh 80,
   window 4,096) and Whisper's encoder (B 8, H 20, S 1,500, dh 64, not
   causal) held to the worst-row limit with a planted fault beside it and
   timed against their bounds and ``scaled_dot_product_attention`` (the
   window as its mask), and the Llama prefill at window 0 beside phase 7;
   Qwen2-VL, Whisper, xLSTM and Zamba2 at SMOKE, one set of seeded weights
   on the card and on the CPU in fp32 and bf16 (prefill logits within
   LOGIT_TOL, flash_attention once a layer, 8 greedy tokens by the
   near-tie rule); then each at full width from seed 0, one at a time
   (Qwen2-VL-72B at 16 of its 80 layers, Whisper-large-v3 whole,
   xLSTM-1.3B at 16 of 48, Zamba2-2.7B at 18 of 54: ZOO_LAYERS): its
   parameter count against the reference's, ``time_model`` and peak
   memory, and the RAG pipeline served closed-loop at concurrency 8
   (``model_<arch>.json``; the cut ones through the ``model`` factory's
   ``cfg=``) with every request answered and flash_attention launched once
   per attention layer of every prefill (16, 64, 3 and 0 a batch) and of
   every embedder and cross-encoder batch;
15. flash bwd (right after phase 7): flash_attention_bwd, from the forward
   kernel's output and log-sum-exp, against its plain version
   (``ref.flash_attention_bwd``) and the exact gradient (autograd of the
   plain attention in fp32) at 960 edge shapes (dh 24, 64, 80, 128 x S
   1, 65, 192, 300 x GQA group 1, 3, 8 x causal or not x (window, soft
   cap) (0, 0), (0, 50), (1, 0), (17, 50), (4,096, 50) x bf16, fp32; bf16
   at dh 64, 80 and 128 on the Hopper design), the forward's log-sum-exp
   against the plain one, autograd of ``ops.flash_attention`` equal to
   the kernel pair; then Phi-4-mini's training shape (B 2, H 24, Hkv 8, S
   4,096, dh 128, causal, bf16): the Hopper design's kernels seen by
   ``torch.profiler``, two calls bit-equal, the kernel, the plain
   version, SDPA's backward with K/V repeated, forward + backward against
   SDPA's, and the bound;
16. train (after phase 12): one fp32 train step of every family at SMOKE
   on the card against the same step on the CPU (loss, gradients,
   updated parameters and moments); Phi-4-mini-3.8B at full width and
   depth (4,450,618,368 random parameters, bf16, remat full) trained on a
   repeated batch of 2 x 4,096 tokens through ``make_train_step``: one
   warm-up and 5 timed steps (CUDA events), tokens/s, MFU against the
   bf16 peak, ``roofline_report``'s bound, peak memory, the attention
   kernels' launches and device-time shares (``torch.profiler``), the
   loss falling at lr TRAIN_LR and every parameter leaf moved (the share
   of its entries that changed, and the parameters' relative change,
   printed); then ``repro_torch.launch.train`` at SMOKE killed after
   its first checkpoint and relaunched, ending bit for bit where an
   uninterrupted run beside it ends;
17. mesh (after phase 16): first, in this process, the unsharded step-1
   losses that (c) and (f) are held to, each model freed after, with (d)
   ``launch.train --arch llama3_8b --smoke --steps 3`` under the host mesh
   (NCCL, a group of one) running beside them. Then four processes on the
   one card, one rank each of a gloo process group
   (``distributed.spawn``; NCCL refuses two ranks on one card), one spawn
   for the rest. First each gloo collective once on CUDA tensors, printed
   as found. (a) The deployment rows (1,048,576 x 384 fp32, capacity
   1,114,112, 32,768 fresh rows, 1 % of documents removed) in a flat
   4-shard DB on mesh (data 4, model 1), held by every rank (host-side
   stores; rank r's card holds shard r for the scan): 20 batches of 64
   queries at k 16 through ``search()`` on the mesh path, equal to the
   host-side merge of the same DB on the card and to the exact top-k,
   ``mesh_searches`` 20 and ``topk_search`` launched on every rank, both
   paths' ``search()`` ms. (b) The llama3 SMOKE train step on (data 2,
   model 2) in fp32 and bf16 against the unsharded step on one rank
   (MESH_TOL), the attention kernels launched on every rank. (e) The MoE
   (Granite, Qwen3), audio, ssm and hybrid SMOKE configs on (data 2,
   model 2) in fp32 and bf16, the MoE ones also in fp32 at capacity
   factor 1: one train step against the unsharded step and a prefill
   with 4 decode steps against the unsharded model's logits, both on
   rank 0 (MESH_TOL; ||d||/||want|| for the logits), the attention
   kernels launched on every rank where the family has attention, and at
   capacity factor 1 the routes dropped unsharded and by rank. (c)
   Phi-4-mini-3.8B at full width and MESH_FULL_LAYERS (4) of its 32
   layers on (data 1, model 4), bf16, batch 2 x 4,096: MESH_TRAIN_STEPS
   timed steps, the first among them, each rank's peak memory and parameter
   bytes (against the specs' shard sizes), the step-1 loss against the
   unsharded one, each rank's attention kernel launches. (f)
   Granite-3.0-1B-A400M at full width and depth on (data 1, model 4),
   bf16, remat full, batch 2 x 4,096, 8 of its 32 experts a rank:
   MESH_TRAIN_STEPS timed steps, the first among them, each rank's peak memory,
   parameter bytes against the specs' shard sizes, experts held, routes
   dropped in a forward of the batch and attention launches, the step-1
   loss within 1e-2 of the unsharded one. The phase wall seconds print as
   ``mesh (a)-(d)``, ``mesh (e)`` and ``mesh (f)`` ((f)'s unsharded step
   in it).

18. experiments (after phase 9): RAGPerf's own experiments
   (``repro_torch.experiments``) and the examples (``repro_torch.examples``).
   (b), inside phase 9 while its Llama-3-8B is resident: Fig. 5's
   generation-model axis at full width, bf16 (``query_breakdown``'s
   pipeline through ``common.build_pipeline(llm=...)``), its four stage
   seconds and ``generation_frac``, flash_attention once a layer. (a)
   Every experiment's ``run(1.0, device="cuda")``, its rows printed; the
   model-free ones (the ``scenarios`` and ``chaos`` suites among them) and
   the quickstart run once more on the CPU in seven processes of their
   own, started beside the kernels' build: the card's rows held to the
   CPU's by ``repro_torch.experiments.common.compare_rows`` (the CPU
   tests' rule: the same names and keys; counts, bytes, flags and the
   retrieve model's bytes equal; quality equal; the shard sweep's and the
   scenario suites' virtual-time values within 1e-9). The serving studies
   each with its own check (``experiments_studies``): ``serving``'s QPS
   sweep, ``stage_pipeline``'s identical outputs, ``elastic_scaling``'s
   check (equivalence and the controller's replay held; elastic against
   static on goodput and p99 printed with its verdict beside a second
   static run's under the same rule, not held: at the study's load no
   stage on the card is busy and both axes differ by noise), ``gen_engine``
   at ``BENCH_CFG`` (equal outputs and an engine TTFT p95 below
   lock-step's; flash_attention in its lock-step prefill),
   ``scenarios``' check (every golden variant twice: the first replay
   equal, key by key and exactly, to its trace recorded on the CPU in
   ``src/repro_torch/scenarios/golden/``, the two replays' golden dicts
   and fault logs equal, the replays deterministic), ``chaos``' check and
   ``overhead``'s 3 % tracing gate at its --smoke size (GOLDEN_SCALE; one
   retry at doubled rounds); the live five's rows held by their flags and
   configured values. (e), inside phase 12 on its Llama-3-8B: the
   ``gen_engine`` point at full width (bf16, ENGINE_FULL_REQUESTS 24),
   equivalence by the near-tie rule, the TTFT p50/p95 of both schedulers,
   the offered load, the speedup and the rows differing at near ties
   printed, not held. (c)
   ``fused_retrieve``'s check over the card's rows: every config equal to
   ``off`` by the parity rule, fresh and mutated, the roofline ordered,
   and the sq8 and PQ micro-batches at least 1.05x faster fused (their
   ms printed). (d) ``quickstart`` (its quality equal to the CPU's),
   ``serve_multiarch --arch llama3_8b`` at SMOKE, and
   ``train_e2e`` 20 steps then relaunched from its checkpoint to 40, the
   loss falling. All five DB kernels, flash_attention and
   flash_attention_bwd must launch in the phase; the wall seconds print
   as ``experiments (a)`` (with the wait for the CPU's processes),
   ``experiments (a) studies``, ``experiments (b)``, ``experiments
   (c)-(d)`` and ``experiments (e)``.

19. lock order (after phase 10): ``scripts/lock_order.py --device cuda``
   in a fresh interpreter, so that each kernel library's first load
   (``kernels._build._lock``) falls inside the recorded window: the
   reference's chaos workload (24 queries through the elastic executor, a
   retrieval replica killed and respawned, a writer stall, one removal)
   over a flat ``torch`` DB and a 4-shard ``torch_sharded`` DB on the
   ``fused`` rung, with the executor's, DBs' (each shard's too), stage
   timer's, accountant's, launch counter's and kernel loader's locks
   instrumented (``repro_torch.analysis.lockorder``). Each graph's edges
   and acquisitions by lock print; the run fails on a cycle, a non-zero
   exit, or a graph in which ``elastic._lock``, ``vectordb._mu`` or the
   launch counter's lock was never taken.

The last lines are one JSON object on the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a card, or run
outside a checkout, it exits non-zero before printing a result.

``python3 chip_smoke.py --lr-witness`` runs ``lr_witness`` alone: the
full-width Phi-4-mini step at 8 layers, bf16 and fp32, by the kernels and
by the plain attention, at lr 3e-4 and 1e-5, printing losses and what
moved.
"""
from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power
# limit) and the bound on them: the port's repro_torch.roofline.analysis,
# the one source of every bound the port prints. Outside a checkout the
# import fails and main() says so.
sys.path.insert(0, str(SRC))
try:
    from repro_torch.roofline.analysis import H100
    from repro_torch.roofline.analysis import bound as hw_bound
except ImportError:
    H100 = hw_bound = None
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
RUNS = 10                  # timed runs per measurement (median reported;
                           # 20 before the experiments phase came)
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


def median_ms(fn, torch, runs=RUNS) -> float:
    """Median over ``runs`` of one call of ``fn`` timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
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


def bound(n_bytes: float, n_flop: float, peak: float = None):
    """Least time on this card in ms (``roofline.analysis.bound`` on
    ``H100``): the larger of bytes over the memory rate and the operations
    over their type's peak (fp32 FMA by default)."""
    sec, by = hw_bound(n_bytes, n_flop,
                       H100.fp32_flops if peak is None else peak)
    return 1e3 * sec, by


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
                    2.0 * NQ * N * DIM, H100.int8_ops)
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
                    2.0 * NQ * n_live * DIM, H100.int8_ops)
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
                        2.0 * NQ * n_live * d, H100.int8_ops)
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
    of each rung's 20 searches and a summary (the configured rung's
    ``search()`` ms per batch on the host clock and by CUDA events, its
    recall@16, the peak memory) for the sharded phase to set beside."""
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

    results, launches, summary = {}, {}, {}
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
        if rung == db._kernel:
            summary["search_host_ms"] = ms
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
    summary.update(recall=recall[db._kernel],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    say(f"{name}: {', '.join(rungs)} equal the off rung (max|dscore| "
        f"{worst:.3g}); recall@{K} against exact fp32 search "
        + ", ".join(f"{r} {v:.4f}" for r, v in recall.items())
        + f"; max_memory_allocated {summary['peak_gib']:.2f} GiB")

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
    summary["search_ms"] = parts["search"]
    say(f"{name}: per batch of {NQ} queries (ms, median of {RUNS}): "
        + ", ".join(f"{part} {t:.4f}" for part, t in parts.items()))
    del db
    torch.cuda.empty_cache()
    return launches, summary


def phase_dbs(torch, ops, ref, compare_topk):
    """The three deployment-size DBs from one row set, each freed before
    the next, then a flat + SQ8 DB at d 768; returns each kernel's launches
    in the DB run that drives it, and the IVF1024 DB's summary."""
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
    got, ivf_summary = run_db(
        torch, ops, ref, compare_topk, data, "db ivf", dict(
            ivf, use_kernel="fused"), {"fused": ("ivf_topk", "topk_search")},
        ivf_kernels, off_chunk=8)
    launches.update(topk_search=got["fused"]["topk_search"],
                    ivf_topk=got["fused"]["ivf_topk"])
    say(f"db ivf: phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    got, _ = run_db(torch, ops, ref, compare_topk, data, "db flat+sq8", dict(
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
        got, _ = run_db(torch, ops, ref, compare_topk, data, "db ivf+pq", dict(
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
    return launches, ivf_summary


# the sharded phase: the deployment's rows over 4 shards (ShardedVectorDB)
N_SHARDS = 4
SMALL_N = 1 << 18          # rows of the parity DBs (flat, 1 shard, SQ8, PQ)


def sharded_db(cfg, n_shards=N_SHARDS):
    from repro_torch.sharded import ShardedDBConfig, ShardedVectorDB

    return ShardedVectorDB(ShardedDBConfig(n_shards=n_shards, **cfg),
                           device=DEVICE)


def fill_db(torch, db, data):
    """Insert ``data``'s rows into ``db`` as ``run_db`` does: the bulk rows,
    the index build, the fresh rows, the removals. Returns every row's
    chunk id on the device (a global id on a sharded DB) and the seconds."""
    from repro_torch.core.interfaces import Chunk

    rows, n, n_fresh = data["rows"], data["n"], data["n_fresh"]
    chunks = [Chunk(-1, i // 4, "") for i in range(n + n_fresh)]
    step = min(1 << 17, n)
    t0 = time.perf_counter()
    for lo in range(0, n, step):
        db.insert(rows[lo:lo + step], chunks[lo:lo + step])
    t1 = time.perf_counter()
    db.build_index()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    db.insert(rows[n:], chunks[n:])
    removed = sum(db.remove(d) for d in data["gone"])
    ids = torch.tensor([c.chunk_id for c in chunks], device=rows.device)
    return ids, dict(insert_s=t1 - t0, build_s=t2 - t1, removed=removed)


def db_state_of(db):
    """A ``TorchVectorDB``'s index state as ``load_state`` takes it (host
    arrays at the true width)."""
    d = db.cfg.dim

    def host(t, cols=None):
        return None if t is None else t[..., :cols].cpu().numpy()

    return {"vectors": host(db.vectors, d), "live": db.live,
            "indexed": db.indexed, "n_slots": db.n_slots,
            "chunks": db.chunks, "doc_slots": db.doc_slots,
            "centroids": host(db.centroids, d), "buckets": host(db.buckets),
            "bucket_live": host(db.bucket_live),
            "sq_codes": host(db.sq_codes, d), "sq_scale": host(db.sq_scale, d),
            "pq_codes": host(db.pq_codes), "pq_codebook": host(db.pq_codebook)}


def live_rows(torch, data):
    """The rows of ``data`` that survive its removals, as a device mask."""
    n = data["n"] + data["n_fresh"]
    live = torch.ones(n, dtype=torch.bool, device=data["rows"].device)
    gone = torch.tensor(data["gone"], device=live.device)
    live[(gone[:, None] * 4 + torch.arange(4, device=live.device)
          ).reshape(-1)] = False
    return live


def exact_topk(torch, ref, data, live, ids, q):
    """Exact fp32 top-K of ``q`` over the surviving rows, as ``(scores,
    chunk ids)`` of the DB that holds them."""
    s, row = ref.topk_search(q, data["rows"], live, K)
    return s, ids[row.long()].to(torch.int32)


def search_all(torch, db, batches):
    """``search()`` of every batch, the user's call: numpy queries in,
    host results out; returns (scores, ids) tensors on the device and the
    host clock's ms per batch."""
    import numpy as np

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    res = [db.search(q.cpu().numpy(), K) for q in batches]
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    return [(torch.from_numpy(np.stack([r.scores for r in b])).to(dev),
             torch.from_numpy(np.stack([r.chunk_ids for r in b])).to(dev))
            for b in res], ms


def fused_equals_off(torch, compare_topk, name, db, batches, results,
                     off_chunk):
    """Every batch's fused results equal the plain ``off`` rung on the same
    state (compared ``off_chunk`` queries at a time)."""
    worst = 0.0
    for (s, i), q in zip(results, batches):
        for lo in range(0, NQ, off_chunk):
            s_off, i_off = db.search_arrays(q[lo:lo + off_chunk], K,
                                            rung="off")
            got = check(f"{name} fused", compare_topk(
                s_off, i_off, s[lo:lo + off_chunk], i[lo:lo + off_chunk]),
                "off rung")
            worst = max(worst, got["max_abs_diff"])
    return worst


def recall_of(results, exact):
    hits = sum(len(set(a.tolist()) & set(e.tolist()))
               for (_, ids), (_, want) in zip(results, exact)
               for a, e in zip(ids, want))
    return hits / (len(results) * NQ * K)


def phase_sharded(torch, ops, ref, compare_topk, unsharded):
    """The sharded DB on the card (see the module docstring, phase 5);
    returns each kernel's launches in the sharded searches, the user's
    ``search()`` of each DB (reset just before, read just after)."""
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB, merge_topk
    from repro_torch.kernels.ref import NEG

    launches = {}

    def searched(db, batches, need, what):
        ops.reset_launch_counts()
        results, ms = search_all(torch, db, batches)
        got = ops.launch_counts()
        for kname in need:
            if got[kname] == 0:
                raise AssertionError(f"{what}: {kname} never launched")
            launches[kname] = launches.get(kname, 0) + got[kname]
        return results, ms, got

    # the deployment: IVF1024 over 4 shards on the fused rung
    data = make_rows(torch)
    live = live_rows(torch, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    db = sharded_db(dict(index_type="ivf", dim=DIM, capacity=DB_CAPACITY,
                         nlist=NLIST, nprobe=NPROBE,
                         flat_capacity=FLAT_CAPACITY, use_kernel="fused"))
    sc = db.shards[0].cfg
    ids, secs = fill_db(torch, db, data)
    st = db.stats()
    fill = max(int(sh.bucket_live.sum(1).max()) for sh in db.shards)
    packed = sum(sh.packed["vecs"].numel() * 4 for sh in db.shards)
    say(f"sharded ivf: {N_SHARDS} shards of {sc.capacity} slots, nlist "
        f"{sc.nlist}, flat {sc.flat_capacity}, bucket capacity "
        f"{db.shards[0].buckets.shape[1]} (max fill {fill}); inserted "
        f"{data['n']} rows in {secs['insert_s']:.1f} s, build_index "
        f"{secs['build_s']:.1f} s, {data['n_fresh']} fresh rows, "
        f"{secs['removed']} rows removed; live {int(st['live'])} (a shard "
        f"{int(st['shard_live_min'])}-{int(st['shard_live_max'])}, "
        f"imbalance {st['shard_imbalance']:.4f}), fresh {int(st['fresh'])}, "
        f"rebuilds {int(st['rebuilds'])}; packed mirrors {packed / 1e9:.2f} "
        f"GB")
    if st["fresh"] == 0 or st["rebuilds"] != N_SHARDS:
        raise AssertionError("sharded ivf: the freshness buffer was folded "
                             "in: no scan")
    merge0 = db.counters["merge_time_s"]
    results, host_ms, got = searched(db, data["batches"],
                                     ("ivf_topk", "topk_search"),
                                     "sharded ivf")
    merge_ms = 1e3 * (db.counters["merge_time_s"] - merge0) / len(results)
    worst = fused_equals_off(torch, compare_topk, "sharded ivf", db,
                             data["batches"], results, off_chunk=8)
    exact = [exact_topk(torch, ref, data, live, ids, q)
             for q in data["batches"]]
    recall = recall_of(results, exact)
    peak = torch.cuda.max_memory_allocated() / 2**30
    q = data["batches"][0]
    q_np = q.cpu().numpy()
    snaps = db.snapshot()
    per = [sh.search_arrays(q, K, snap) for sh, snap in zip(db.shards, snaps)]
    offset = [torch.where(s > NEG / 2, i + j * db.shard_capacity, -1)
              for j, (s, i) in enumerate(per)]

    def merge_only():
        s, i = per[0][0], offset[0]
        for (s2, _), i2 in zip(per[1:], offset[1:]):
            s, i = merge_topk(s, i, s2, i2, K)
        return s, i

    parts = {"search": median_ms(lambda: db.search(q_np, K), torch),
             "search_arrays fused": median_ms(
                 lambda: db.search_arrays(q, K), torch),
             "shard 0 search_arrays": median_ms(
                 lambda: db.shards[0].search_arrays(q, K, snaps[0]), torch),
             "the 3 merges": median_ms(merge_only, torch)}
    base = unsharded
    say(f"sharded ivf: 20 batches of {NQ} queries at k={K}: search() "
        f"{host_ms:.3f} ms per batch (host clock; unsharded IVF1024 "
        f"{base['search_host_ms']:.3f}); recall@{K} against exact fp32 "
        f"{recall:.4f} (unsharded {base['recall']:.4f}); fused equals off "
        f"(max|dscore| {worst:.3g}); merge_time_s {merge_ms:.4f} ms per "
        f"batch (host time of the merges' launches); shard_imbalance "
        f"{st['shard_imbalance']:.4f}; max_memory_allocated {peak:.2f} GiB "
        f"(unsharded {base['peak_gib']:.2f}); launches {got}")
    say(f"sharded ivf: per batch of {NQ} queries (ms, median of {RUNS}, CUDA "
        f"events): " + ", ".join(f"{p} {t:.4f}" for p, t in parts.items())
        + f" (unsharded search() {base['search_ms']:.4f})")
    del db, per, offset, snaps, results
    torch.cuda.empty_cache()
    # the same rows over 4 shards of the unsharded DB's list size (1,024
    # lists a shard): is the recall the coarser lists', or the sharding's?
    db = sharded_db(dict(index_type="ivf", dim=DIM, capacity=DB_CAPACITY,
                         nlist=N_SHARDS * NLIST, nprobe=NPROBE,
                         flat_capacity=FLAT_CAPACITY, use_kernel="fused"))
    ids, _ = fill_db(torch, db, data)
    results, _ = search_all(torch, db, data["batches"])
    exact = [exact_topk(torch, ref, data, live, ids, q)
             for q in data["batches"]]
    say(f"sharded ivf, {db.shards[0].cfg.nlist} lists a shard (global "
        f"{N_SHARDS * NLIST}): recall@{K} {recall_of(results, exact):.4f} "
        f"(256 a shard: {recall:.4f}; unsharded 1,024: "
        f"{base['recall']:.4f})")
    del db, results, exact, data, live, ids
    torch.cuda.empty_cache()

    # the parity DBs, at a quarter of the rows
    small = make_rows(torch, n=SMALL_N, n_fresh=8192,
                      capacity=SMALL_N + 16384, flat_capacity=16384)
    live = live_rows(torch, small)
    cfg = dict(dim=DIM, capacity=small["capacity"], nlist=NLIST,
               nprobe=NPROBE, flat_capacity=small["flat_capacity"],
               use_kernel="fused")
    # flat over 4 shards: each shard's topk_search, merged: the exact top-k
    db = sharded_db(dict(cfg, index_type="flat"))
    ids, _ = fill_db(torch, db, small)
    results, ms, got = searched(db, small["batches"], ("topk_search",),
                                "sharded flat")
    worst = 0.0
    for (s, i), q in zip(results, small["batches"]):
        want = exact_topk(torch, ref, small, live, ids, q)
        worst = max(worst, check("sharded flat", compare_topk(
            *want, s, i), "exact search")["max_abs_diff"])
    say(f"sharded flat ({small['n']} rows, 4 shards): ids equal the exact "
        f"global top-{K} outside near ties (max|dscore| {worst:.3g}); "
        f"search() {ms:.3f} ms per batch; launches {got}")
    del db
    # one shard: a bare TorchVectorDB's results, bit for bit, on one state
    one = sharded_db(dict(cfg, index_type="ivf"), n_shards=1)
    bare = TorchVectorDB(DBConfig(index_type="ivf", **cfg), device=DEVICE)
    if one._shard_cfg() != bare.cfg:
        raise AssertionError(f"1 shard: {one._shard_cfg()} != {bare.cfg}")
    fill_db(torch, bare, small)
    one.shards[0].load_state(db_state_of(bare))
    for q in small["batches"]:
        a, b = one.search(q.cpu().numpy(), K), bare.search(q.cpu().numpy(), K)
        if not all((x.chunk_ids == y.chunk_ids).all()
                   and (x.scores == y.scores).all() for x, y in zip(a, b)):
            raise AssertionError("1 shard: results differ from TorchVectorDB")
    say(f"sharded ivf, 1 shard: {len(small['batches'])} batches equal a bare "
        f"TorchVectorDB's on its state, bit for bit (ids and scores)")
    del one, bare
    # flat + SQ8 and IVF + PQ over 4 shards: fused against off
    for name, kw, kname, off_chunk in (
            ("sharded flat+sq8", dict(index_type="flat", quant="sq8"),
             "sq8_topk", NQ),
            ("sharded ivf+pq", dict(index_type="ivf", quant="pq"),
             "pq_topk", 8)):
        db = sharded_db(dict(cfg, **kw))
        fill_db(torch, db, small)
        results, ms, got = searched(db, small["batches"], (kname,), name)
        worst = fused_equals_off(torch, compare_topk, name, db,
                                 small["batches"], results, off_chunk)
        pq = (f", pq_m {db.shards[0].cfg.pq_m}" if kw["quant"] == "pq"
              else "")
        say(f"{name} ({small['n']} rows, 4 shards{pq}): fused equals off "
            f"(max|dscore| {worst:.3g}); search() {ms:.3f} ms per batch; "
            f"launches {got}")
        del db
    del small, live
    torch.cuda.empty_cache()

    # the shard_scale scenario on the fused sharded DB
    t0 = time.perf_counter()
    sim_parity(torch, ops, DEVICE, names=("shard_scale",))
    live_scenarios(torch, ops, DEVICE, names=("shard_scale",))
    say(f"sharded: shard_scale sim and live {time.perf_counter() - t0:.1f} s")
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
    "qwen3-moe prefill": (8, 32, 4, 512, 128, True),   # GQA group 8
    "llm prefill S=500": (8, 32, 8, 500, 128, True),   # ragged last tile
    "embedder": (64, 4, 4, 128, 64, False),         # d_model 256, batch 64
    "cross-encoder": (32, 4, 4, 192, 64, False),    # d_model 256, batch 32
}


def row_rel_err(got, want) -> float:
    """The worst query row's ||got - want|| / ||want|| over the head dim,
    in fp32."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def dropped_tile_attention(torch, q, k, v, causal, window=0):
    """A planted fault for the row check: fp32 attention in which the K/V
    tile of keys [64, 128) is skipped by every query row whose q tile reads
    all of it (every row when not causal, rows from 128 on when causal);
    with a window, keys j <= i - window are masked as the kernel masks
    them."""
    rep = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(rep, 1).float() for x in (k, v))
    S = q.shape[2]
    i = torch.arange(S, device=q.device)
    rows = i[:, None] >= (128 if causal else 0)
    mask = rows & (i[None, :] >= 64) & (i[None, :] < 128)
    if causal:
        mask |= i[None, :] > i[:, None]
    if window > 0:
        mask |= i[None, :] <= i[:, None] - window
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
        bms, by = bound(n_bytes, n_flop, H100.peak_flops)
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


# the backward's gradients against its plain version (ref.flash_attention_bwd,
# which rounds P and dS where the kernel does), as max|d| over the largest
# |want| of the three gradients (at S 1, dq and dk are 0): bf16 rounds dq,
# dk and dv once (2^-9) and sums in another order; fp32 sums in another
# order
BWD_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# ... and against the exact gradient (autograd of the plain attention in
# fp32 on the same inputs): bf16 also rounds P, dS and the forward's output
BWD_EXACT_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# the forward's log-sum-exp against the plain one in fp32 (logits of |s|
# < ~10; bf16 products accumulate in fp32, so only the sum order differs)
LSE_TOL = 1e-3
# the edge sweep's (window, soft cap) pairs: 50 is Gemma 2's attention
# logit cap (arXiv:2408.00118); a capped shape's q is scaled by CAP_Q so
# that its logits bend
BWD_WINDOW_CAPS = ((0, 0.0), (0, 50.0), (1, 0.0), (17, 50.0), (4096, 50.0))
CAP_Q = 4.0
# the backward's kernels by name: the Hopper design's three, the others'
BWD_KERNELS = ("bwd_wgmma_kernel", "wg::pre_kernel", "wg::post_kernel",
               "dkdv_", "dq_bf16", "dq_f32", "dot_kernel")
# Phi-4-mini-3.8B's attention in the train phase: batch 2 of 4,096 tokens
TRAIN_ATTN = (2, 24, 8, 4096, 128, True)


def grad_err(got, want) -> float:
    """max|got - want| over the gradients (dq, dk, dv), over the largest
    |want| of the three, in fp32."""
    scale = max(float(w.float().abs().max()) for w in want)
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want)) / max(scale, 1e-30)


def phase_flash_bwd(torch, ops, ref):
    """flash_attention_bwd (and the forward's log-sum-exp) against their
    plain versions and the exact gradient at the edge shapes, the
    autograd path, then the training shape's times beside SDPA's
    backward and the bound; returns the kernel's record."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.roofline import op_cost

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def inputs(B, H, hkv, S, dh, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, H, S, dh), (B, hkv, S, dh), (B, hkv, S, dh),
                              (B, H, S, dh))]

    worst = {dt: [0.0, 0.0, 0.0] for dt in dtypes}   # ref, exact, lse
    worst_abs, n = 0.0, 0
    for dt, dh, S, group, causal, (window, cap) in itertools.product(
            dtypes, (24, 64, 80, 128), (1, 65, 192, 300), (1, 3, 8),
            (True, False), BWD_WINDOW_CAPS):
        q, k, v, do = inputs(1, 2 * group, 2, S, dh, dtypes[dt])
        if cap:
            q = q * CAP_Q
        o, lse = tfa.flash_attention_cuda(q, k, v, causal, window,
                                          with_lse=True, softcap=cap)
        e_lse = float((lse - ref.attention_lse(
            q, k, causal=causal, window=window, softcap=cap)).abs().max())
        got = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal,
                                           window, cap)
        want = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       window=window, softcap=cap)
        leaf = [t.float().requires_grad_() for t in (q, k, v)]
        exact = torch.autograd.grad(
            ref.flash_attention(*leaf, causal=causal, window=window,
                                softcap=cap), leaf, do.float())
        e_ref, e_exact = grad_err(got, want), grad_err(got, exact)
        worst_abs = max(worst_abs, *(float((g.float() - w.float()).abs()
                                           .max()) for g, w in zip(got, want)))
        if not (e_ref <= BWD_TOL[dt] and e_exact <= BWD_EXACT_TOL[dt]
                and e_lse <= LSE_TOL):
            raise AssertionError(
                f"flash_attention_bwd {dt} dh={dh} S={S} group={group} "
                f"causal={causal} window={window} softcap={cap}: against "
                f"the plain "
                f"version {e_ref:.3g} (limit {BWD_TOL[dt]}), the exact "
                f"gradient {e_exact:.3g} (limit {BWD_EXACT_TOL[dt]}), lse "
                f"{e_lse:.3g} (limit {LSE_TOL})")
        for i, e in enumerate((e_ref, e_exact, e_lse)):
            worst[dt][i] = max(worst[dt][i], e)
        n += 1
    say(f"flash_attention_bwd: {n} edge shapes (dh 24, 64, 80, 128 x S 1, "
        f"65, 192, 300 x GQA group 1, 3, 8 x causal or not x (window, soft "
        f"cap) {BWD_WINDOW_CAPS} x bf16, fp32; bf16 at dh 64, 80, 128 on "
        f"the Hopper design) pass; worst against the plain "
        f"version, the exact gradient, and the forward's lse: " + "; ".join(
            f"{dt} {w[0]:.3g}, {w[1]:.3g}, {w[2]:.3g}"
            for dt, w in worst.items()) + f" (max|d| {worst_abs:.3g})")

    # the autograd path: ops.flash_attention on inputs that need grad
    for dt, dtype in dtypes.items():
        q, k, v, do = inputs(2, 6, 2, 130, 80, dtype)
        leaf = [t.clone().requires_grad_() for t in (q, k, v)]
        before = ops.launch_counts()
        out = ops.flash_attention(*leaf, causal=True, window=64)
        got = torch.autograd.grad(out, leaf, do)
        after = ops.launch_counts()
        o, lse = tfa.flash_attention_cuda(q, k, v, True, 64, with_lse=True)
        want = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, True, 64)
        if not (all(torch.equal(g, w) for g, w in zip(got, want))
                and torch.equal(out, o)
                and after["flash_attention_bwd"]
                == before["flash_attention_bwd"] + 1):
            raise AssertionError(f"ops.flash_attention {dt}: autograd does "
                                 f"not go through the backward kernel")
    say("flash_attention: autograd of ops.flash_attention on the card is the "
        "kernel pair, bit for bit (bf16, fp32)")

    B, H, hkv, S, dh, causal = TRAIN_ATTN
    q, k, v, do = inputs(B, H, hkv, S, dh, torch.bfloat16)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal, with_lse=True)

    def kernel():
        return tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)

    def plain():
        return ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = kernel()
        torch.cuda.synchronize()
    again = kernel()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("flash_attention_bwd at the training shape: "
                             "two calls differ (dQ's sum order is fixed)")
    by_kernel = {e.key: e.self_device_time_total / 1e3
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
    if not any("bwd_wgmma_kernel" in key for key in by_kernel) or any(
            "dkdv_" in key for key in by_kernel):
        raise AssertionError(f"flash_attention_bwd at the training shape "
                             f"did not run the Hopper design: {by_kernel}")
    say("flash_attention_bwd at the training shape: the Hopper design, two "
        "calls bit-equal; device ms by kernel (torch.profiler, one call): "
        + ", ".join(f"{re.sub(r'^void |[(].*$', '', key)} {ms:.4f}"
                    for key, ms in by_kernel.items()))
    want = plain()
    err = grad_err(got, want)
    abs_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
    if err > BWD_TOL["bfloat16"]:
        raise AssertionError(f"flash_attention_bwd at the training shape: "
                             f"{err} against the plain version")
    del got, again, want
    torch.cuda.empty_cache()
    lq, lk, lv = (t.detach().clone().requires_grad_()
                  for t in (q, k.repeat_interleave(H // hkv, 1),
                            v.repeat_interleave(H // hkv, 1)))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

    def library():   # SDPA's backward alone, K/V repeated
        return torch.autograd.grad(lo, (lq, lk, lv), do, retain_graph=True)

    gq, gk, gv = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def kernel_pair():   # forward with lse + backward, through autograd
        return torch.autograd.grad(
            ops.flash_attention(gq, gk, gv, causal=causal), (gq, gk, gv), do)

    def library_pair():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal), (lq, lk, lv), do)

    t = {"ms": kernel_ms(kernel, torch), "call_ms": median_ms(kernel, torch),
         "plain_ms": median_ms(plain, torch, runs=3),
         "library_ms": kernel_ms(library, torch),
         "library_call_ms": median_ms(library, torch),
         "fwd_bwd_ms": kernel_ms(kernel_pair, torch),
         "library_fwd_bwd_ms": kernel_ms(library_pair, torch)}
    fwd_flop = op_cost.attention_flops(q.shape, causal, 0)
    n_flop = op_cost.BWD_FLOP_RATIO * fwd_flop
    # q, o, dO read and dq written; k, v read and dk, dv written; lse read
    n_bytes = 2 * (4 * B * H * S * dh + 4 * B * hkv * S * dh) + 4 * B * H * S
    bms, by = bound(n_bytes, n_flop, H100.peak_flops)
    say(f"flash_attention_bwd at the training shape B={B} H={H} Hkv={hkv} "
        f"S={S} dh={dh} causal bf16: kernel {t['ms']:.4f} ms (single calls "
        f"{t['call_ms']:.4f}), plain {t['plain_ms']:.2f} ms, SDPA's backward "
        f"(K/V repeated) {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}; "
        f"{n_bytes / 1e6:.1f} MB, {n_flop / 1e9:.1f} GFLOP), "
        f"{t['ms'] / t['library_ms']:.3f}x SDPA, {100 * bms / t['ms']:.1f} % "
        f"of the bound; forward + backward {t['fwd_bwd_ms']:.4f} ms against "
        f"SDPA's {t['library_fwd_bwd_ms']:.4f} ms; max|d| {abs_err:.3g}")
    del lq, lk, lv, lo, gq, gk, gv
    torch.cuda.empty_cache()
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="none: src/repro/train/train_step.py:90 "
                         "differentiates the einsums of "
                         "src/repro/models/layers.py:213 (the Pallas kernel "
                         "at src/repro/kernels/flash_attention.py:85 has no "
                         "backward)",
                shape=dict(zip(("B", "H", "Hkv", "S", "dh", "causal"),
                               TRAIN_ATTN)),
                max_abs_err=max(worst_abs, abs_err), max_rel_err=err,
                bound_ms=bms, bound_by=by, **t)


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


def model_inputs(torch, model, B, S, gen):
    """A generate batch of ``model``'s family as ``ModelLLM`` builds it:
    (the prefill's input, its keyword arguments, a decode step's input
    given the greedy ids). Token rows have real lengths 250-350 padded
    with 0 to S; the per-row families take the lengths, the lock-step ones
    (audio, ssm, hybrid) the padded batch; the vlm backbone seeded random
    embeddings in place of ids, Whisper seeded random frames."""
    cfg = model.cfg
    dtype = next(model.parameters()).dtype
    lengths = torch.randint(250, 351, (B,), generator=gen, device=DEVICE)
    tokens = torch.randint(4, cfg.vocab_size, (B, S), generator=gen,
                           device=DEVICE)
    tokens[torch.arange(S, device=DEVICE)[None, :] >= lengths[:, None]] = 0
    kw = {}
    if cfg.family in ("dense", "moe", "vlm"):
        kw["lengths"] = lengths
    if cfg.family == "audio":
        kw["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                   generator=gen, device=DEVICE).to(dtype)
    if cfg.uses_tokens:
        return tokens, kw, lambda cur: cur
    step = torch.randn((B, 1, cfg.d_model), generator=gen,
                       device=DEVICE).to(dtype)
    return (torch.randn((B, S, cfg.d_model), generator=gen,
                        device=DEVICE).to(dtype), kw, lambda cur: step)


def time_model(torch, model, runs=RUNS) -> dict:
    """Where a generate batch's time goes, at the serving spec's shape
    (8 rows padded to 512 tokens, real lengths 250-350; ``model_inputs``):
    the prefill and one decode step (CUDA events, median of ``runs``), and
    the kernels one decode step launches with their device time
    (torch.profiler). The step's bound is every weight read once; an MoE's
    also beside the bound of reading only the experts its step routes a
    token to (counted in one step, per layer), and one prefill's launches
    and device time. Returns the numbers it prints."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api
    from repro_torch.models import moe as moe_lib

    cfg = model.cfg
    B, S, new = 8, 512, 16
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    first, kw, step_input = model_inputs(torch, model, B, S, gen)
    with torch.inference_mode():
        cache = model.init_cache(B, S + new + 2 * runs + 8)
        prefill_ms = median_ms(lambda: model.prefill(first, cache, **kw),
                               torch, runs)
        logits, cache = model.prefill(first, cache, **kw)
        cur = step_input(logits.argmax(-1)[:, None])
        step_ms = median_ms(lambda: model.decode_step(cur, cache), torch,
                            runs)
        used = []
        if cfg.moe is not None:       # experts routed to, layer by layer
            router = moe_lib._router

            def counting(params, x, m):
                out = router(params, x, m)
                used.append(int(out[1].unique().numel()))
                return out

            moe_lib._router = counting
            try:
                model.decode_step(cur, cache)
            finally:
                moe_lib._router = router
        steps = 4
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                logits, cache = model.decode_step(cur, cache)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pprof:
            model.prefill(first, cache, **kw)
            torch.cuda.synchronize()
        pre = [e for e in pprof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in kernels) / steps
    busy_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    # bound of a decode step: every weight read once; of the prefill: its
    # model FLOPs at the bf16 tensor cores' peak
    weight_bytes = api.param_bytes(model)
    out = dict(prefill_ms=prefill_ms, step_ms=step_ms,
               bound_step_ms=1e3 * weight_bytes / H100.hbm_bw,
               bound_prefill_ms=1e3 * api.model_flops(cfg, B, S, "prefill")
               / H100.peak_flops)
    head = (f"{cfg.name} at B={B}, S={S}: prefill {prefill_ms:.2f} ms "
            f"(bound {out['bound_prefill_ms']:.2f} ms: model FLOPs at the "
            f"bf16 peak), decode step {step_ms:.2f} ms (bound "
            f"{out['bound_step_ms']:.2f} ms: the weights read once, "
            f"{weight_bytes / 1e9:.2f} GB)")
    if used:
        m = cfg.moe
        expert = 3 * cfg.d_model * m.expert_d_ff * 2      # bf16 bytes
        read = weight_bytes - expert * (cfg.n_layers * m.num_experts
                                        - sum(used))
        out.update(experts_used=sum(used) / len(used),
                   bound_routed_ms=1e3 * read / H100.hbm_bw)
        head += (f"; the step routes to {out['experts_used']:.1f} of "
                 f"{m.num_experts} experts a layer (mean of {len(used)} "
                 f"layers): bound {out['bound_routed_ms']:.2f} ms if only "
                 f"those were read ({read / 1e9:.2f} GB); the sort dispatch "
                 f"reads every expert")
    if not kernels:
        say(f"{head}; kernels per decode step and device time not measured "
            f"(the profiler saw no device activity)")
        return out
    out.update(launches_per_step=n_kernels, busy_ms=busy_ms,
               idle_share=1 - busy_ms / step_ms)
    if pre:
        busy = sum(e.self_device_time_total for e in pre) / 1e3
        out.update(prefill_launches=sum(e.count for e in pre),
                   prefill_busy_ms=busy, prefill_idle_share=1 - busy /
                   prefill_ms)
        head += (f"; one prefill launches {out['prefill_launches']} kernels, "
                 f"device busy {busy:.2f} ms of it (idle share "
                 f"{out['prefill_idle_share']:.3f})")
    say(f"{head}; one decode step launches {n_kernels:.0f} kernels, device "
        f"busy {busy_ms:.2f} ms of it (idle share "
        f"{1 - busy_ms / step_ms:.3f}); most device time: "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / steps / 1e3:.3f}"
                    f" ms" for e in top))
    return out


def phase_model_full(torch, ops, with_model=None):
    """Llama-3-8B at full width on the card: the parameter count, then the
    RAG pipeline served with it; returns flash_attention's launches in the
    serve run and what ``with_model`` (called with the model before it is
    freed) returns."""
    from repro_torch import configs
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
    held = with_model(model) if with_model else None
    del model, logits
    torch.cuda.empty_cache()
    return serve_counted(torch, ops, SRC / "repro_torch" / "specs" /
                         "model_llama3_8b.json", cfg), held


def serve_counted(torch, ops, spec, cfg, n_requests=None, concurrency=0,
                  per_prefill=None, inject_cfg=False):
    """``repro_torch.launch.serve`` of a model spec over ``n_requests``
    (MODEL_REQUESTS) requests lock-step: sync, or closed loop at
    ``concurrency`` with batches of 8. No request fails, every query is
    answered with 16 tokens, the DB's kernels launch, and flash_attention
    launches ``per_prefill`` (default ``cfg.n_layers``) times in every
    prefill batch and once per layer of every embedder and cross-encoder
    batch. With ``inject_cfg`` the spec's llm is built from ``cfg``
    through the factory's ``cfg=`` argument. Returns flash_attention's
    launches."""
    import dataclasses
    import gc
    import threading

    from repro_torch.core import embedder, reranker
    from repro_torch.launch import serve
    from repro_torch.models import api

    n_requests = n_requests or MODEL_REQUESTS
    per_prefill = cfg.n_layers if per_prefill is None else per_prefill
    # every consumer's batch launches flash_attention once per layer
    batches = {"prefill": 0, "embed": 0, "cross": 0}
    lock = threading.Lock()
    wrapped = [(api.get_model(cfg).Model, "prefill", "prefill"),
               (embedder, "_encode_fn", "embed"),
               (reranker, "_cross_score", "cross")]
    if inject_cfg:
        wrapped.append((serve, "build", None))
    saved = [getattr(owner, attr) for owner, attr, _ in wrapped]

    def counting(fn, key):
        def call(*args, **kw):
            with lock:
                batches[key] += 1
            return fn(*args, **kw)
        return call

    def build(spec, **kw):   # the spec's llm built from cfg
        llm = dataclasses.replace(spec.llm,
                                  options={**spec.llm.options, "cfg": cfg})
        return saved[-1](dataclasses.replace(spec, llm=llm), **kw)

    argv = ["--config", str(spec), "--docs", "256", "--requests",
            str(n_requests), "--device", DEVICE]
    if concurrency:
        argv += ["--mode", "closed", "--concurrency", str(concurrency),
                 "--batch", "8", "--slo-ms", str(MODEL_SLO_MS)]
    else:
        argv += ["--mode", "sync"]
    for (owner, attr, key), fn in zip(wrapped, saved):
        setattr(owner, attr, counting(fn, key) if key else build)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        doc = serve.main(argv)
    finally:
        for (owner, attr, _), fn in zip(wrapped, saved):
            setattr(owner, attr, fn)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    # one launch per attention layer: per_prefill in the generator, 4 in
    # each encoder
    want = (per_prefill * batches["prefill"]
            + ENCODER_LAYERS * (batches["embed"] + batches["cross"]))
    gen, s = doc["gen"], doc.get("summary", {})
    n_queries = doc["ops"].get("query", 0)
    if (launches["flash_attention"] != want or not gen
            or s.get("n_failed", 0) or gen["n_requests"] != n_queries
            or n_queries == 0 or gen["tokens_out"] != 16 * n_queries
            or sum(doc["ops"].values()) != n_requests
            or min(launches["ivf_topk"], launches["topk_search"]) == 0):
        raise AssertionError(f"serve {spec.stem}: launches {launches} "
                             f"(flash want {want} from {batches}), ops "
                             f"{doc['ops']}, gen {gen}, summary {s}")
    mode = f"closed at concurrency {concurrency}" if concurrency else "sync"
    load = (f"{s['achieved_qps']:.3f} QPS, latency p50/p95/p99 "
            f"{s['p50_latency_ms']:.1f} / {s['p95_latency_ms']:.1f} / "
            f"{s['p99_latency_ms']:.1f} ms, mean batch "
            f"{s.get('mean_batch_size', 0.0):.2f}; " if s else "")
    tok_s = gen["tokens_out"] / doc["stage_breakdown"]["generation"]
    llm = f", the llm {cfg.name}" if inject_cfg else ""
    say(f"serve {spec.stem} ({mode}{llm}): {sum(doc['ops'].values())} "
        f"requests ({doc['ops']}) in {wall:.1f} s, every query answered "
        f"with 16 tokens; {load}batches {batches}: flash_attention "
        f"{launches['flash_attention']} = {per_prefill} x "
        f"{batches['prefill']} prefills + {ENCODER_LAYERS} x "
        f"{batches['embed'] + batches['cross']} encoder batches; launches "
        f"{launches}; TTFT p50 {1e3 * gen['ttft_p50_s']:.2f} ms, TPOT p50 "
        f"{1e3 * gen['tpot_p50_s']:.2f} ms, {tok_s:.1f} generated tokens/s "
        f"over the generation stage; stage breakdown (s) "
        f"{ {k: round(v, 3) for k, v in doc['stage_breakdown'].items()} }; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches["flash_attention"]



# the experiments phase: RAGPerf's own experiments (repro_torch.experiments)
# and the examples (repro_torch.examples) on the card
# the model-free experiments (and the quickstart), run once more on the
# CPU in seven processes of one thread each, balanced by their CPU seconds
# (the work is mostly host Python). They start beside the kernels' build,
# whose nvcc processes leave cores idle, and have ended long before the
# card's rows are held to theirs (beside the card's run, until this script
# started them with the build, they outlasted it by 19-28 s)
EXPERIMENTS_ON_CPU = (
    ("quickstart",), ("resource_limits",),
    ("sensitivity", "resource_utilization"),
    ("sharded_retrieval", "index_schemes"),
    ("accuracy_eval", "fused_retrieve"),
    ("update_workload", "monitor_overhead"),
    ("scenarios", "chaos"))
CPU_THREADS = 1
E2E_STEPS = 40             # train_e2e: 20 steps, then a relaunch to 40
EXPERIMENT_KERNELS = ("topk_search", "ivf_topk", "sq8_topk", "pq_topk",
                      "quant_score", "flash_attention", "flash_attention_bwd")
# RAGPerf's serving studies in (a): each runs on the card with its own
# check. The live five's rows measure the card's wall clock (coalescing,
# autoscale events and span counts follow it too), so they are held by
# their flags and configured values; the simulated two run on the CPU too
# (EXPERIMENTS_ON_CPU) and are held to its rows
LIVE_STUDIES = ("serving", "stage_pipeline", "elastic_scaling", "gen_engine",
                "overhead")
SIM_STUDIES = ("scenarios", "chaos")
OVERHEAD_RUNS = 3          # the overhead gate's interleaved rounds, at its
                           # --smoke size (GOLDEN_SCALE) for the run's time
# elastic_scaling's sizes at scale 1.0 (its sweep's), for the control run
ELASTIC_DOCS, ELASTIC_REQUESTS = 48, 160


def experiments_on_cpu():
    """Start the model-free experiments and the quickstart at scale 1.0 on
    the CPU, in processes of their own with the card hidden (one per group
    of EXPERIMENTS_ON_CPU), each of which writes its rows to its path under
    build/. Returns the processes and their paths; any still running when
    this script exits is killed."""
    import atexit
    import os

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    paths = [build / f"experiments_cpu_{i}.json"
             for i in range(len(EXPERIMENTS_ON_CPU))]
    for path in paths:
        path.unlink(missing_ok=True)
    code = (
        "import json, sys, torch\n"
        f"torch.set_num_threads({CPU_THREADS})\n"
        "from repro_torch.examples import quickstart\n"
        "from repro_torch.experiments import run\n"
        "rows = {}\n"
        "for n in sys.argv[2:]:\n"
        "    if n == 'quickstart':\n"
        "        q = quickstart.main(['--device', 'cpu'])\n"
        "        rows[n] = {k: q[k] for k in ('n_chunks', 'quality')}\n"
        "    else:\n"
        "        rows[n] = run.MODULES[n].run(1.0, 'cpu')\n"
        "open(sys.argv[1], 'w').write(json.dumps(rows))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(path), *names], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for path, names in zip(paths, EXPERIMENTS_ON_CPU)]
    atexit.register(lambda: [proc.kill() for proc in procs])
    return procs, paths


def experiments_cpu_rows(procs, paths):
    """The CPU processes' rows, once each has ended well."""
    rows = {}
    try:
        for proc, path in zip(procs, paths):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"experiments on the CPU: exit "
                                     f"{proc.returncode}\n{err[-4000:]}")
            rows.update(json.loads(Path(path).read_text()))
    finally:
        for proc in procs:
            proc.kill()
    return rows


def row_text(row) -> str:
    return f"{row['bench']}: " + ", ".join(
        f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in row.items() if k != "bench")


def experiments_fig5(torch, ops, model):
    """(b): Fig. 5's generation-model axis at full Llama-3-8B width, bf16,
    with ``model`` (phase 9's, still resident) behind
    ``common.build_pipeline(llm=...)``; returns its launches and wall
    seconds."""
    from repro_torch import configs
    from repro_torch.core.generator import ModelLLM
    from repro_torch.experiments import query_breakdown as qb

    t0 = time.perf_counter()
    cfg = configs.get_config("llama3_8b")
    corpus = qb.make_corpus(32)
    questions = qb.questions_for(corpus, 16)
    ops.reset_launch_counts()
    llm = ModelLLM(cfg, max_prompt=64, max_new=4, batch_size=4,
                   device=DEVICE, model=model)
    pipe = qb.model_pipeline(corpus, questions, llm, DEVICE)
    launches = ops.launch_counts()
    row = qb.model_row("llama3_8b", pipe)
    bd = pipe.breakdown()
    answers = [t.answer for t in pipe.traces]
    if (launches["flash_attention"] < cfg.n_layers or len(answers) != 4
            or not all(answers) or not 0 < row["generation_frac"] < 1):
        raise AssertionError(f"experiments (b): launches {launches}, "
                             f"answers {answers}, row {row}")
    say(f"experiments (b): Fig. 5 at full width, llama3_8b bf16 "
        f"({cfg.n_layers} layers, d {cfg.d_model}) behind the axis's "
        f"pipeline, 4 questions: " + ", ".join(
            f"{s} {bd.get(s, 0.0):.6f} s" for s in qb.QUERY_STAGES)
        + f"; {row_text(row)}; flash_attention {launches['flash_attention']}"
        f" launches")
    return launches, time.perf_counter() - t0


def held_live(name, rows, values):
    """A live study's rows on the card: the bench names of ``values`` in
    order, each value finite and not negative, a throughput positive
    (``common.compare_rows`` of the rows against themselves), and each
    flag or configured key at its value in ``values`` (bench -> key ->
    value). Returns the values held."""
    from repro_torch.experiments import common

    benches = [r["bench"] for r in rows]
    if benches != list(values):
        raise AssertionError(f"experiments (a) {name}: rows {benches}, "
                             f"want {list(values)}")
    common.compare_rows(rows, rows)
    held = 0
    for row in rows:
        for key, want in values[row["bench"]].items():
            if row[key] != want:
                raise AssertionError(f"experiments (a) {name}: "
                                     f"{row['bench']} {key} {row[key]!r}, "
                                     f"want {want!r}")
            held += 1
    return held


def experiments_studies(torch, ops):
    """(a)'s serving studies on the card, each with its own check, which
    raises on failure: ``stage_pipeline``'s identical outputs (inside its
    run), ``elastic_scaling``'s equivalence and controller replay,
    ``gen_engine``'s equivalence and TTFT-p95 win at ``BENCH_CFG``,
    ``scenarios.check`` (every golden variant twice: the first replay equal
    to its CPU-recorded trace, golden dicts and fault logs equal, the
    controller's replay deterministic), ``chaos.check`` and
    ``overhead``'s 3 % gate with its one retry at doubled rounds.
    ``elastic_scaling.check``'s timing rule (elastic not worse than static
    on both goodput and p99) is printed beside the same rule applied to a
    second static run against the first, not held: at the study's load no
    stage on the card is busy, so both axes differ by noise, and a second
    static run breaks the rule too (PERF.md, the serving studies). Returns
    each study's rows."""
    from repro_torch.experiments import (chaos, elastic_scaling, gen_engine,
                                         overhead, scenarios, serving,
                                         stage_pipeline)
    from repro_torch.scenarios.registry import GOLDEN_SCALE

    rows, walls, held = {}, {}, {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        return out

    rows["serving"] = part("serving", lambda: serving.run(1.0, DEVICE))
    qps = (25, 50, 100, 200)
    held["serving"] = held_live("serving", rows["serving"], {
        **{f"serving_open_q{q}": {"offered_qps": float(q)} for q in qps},
        "serving_closed_c4": {"concurrency": 4.0}})

    rows["stage_pipeline"] = part("stage_pipeline",
                                  lambda: stage_pipeline.run(1.0, DEVICE))
    stages = [r["bench"].split("/")[2] for r in rows["stage_pipeline"]
              if r["bench"].count("/") == 2 and "/b4/" in r["bench"]]
    held["stage_pipeline"] = held_live(
        "stage_pipeline", rows["stage_pipeline"],
        {b: {} for batch in (4, 8, 16) for b in
         [f"stage_pipeline/b{batch}"]
         + [f"stage_pipeline/b{batch}/{st}" for st in stages]})
    say("experiments (a) stage_pipeline: lock-step, samebatch and "
        "stagebatch outputs identical at batch 4, 8 and 16; " + "; ".join(
            f"{r['bench']}: lockstep_qps {r['lockstep_qps']:.2f}, "
            f"pipelined_qps {r['pipelined_qps']:.2f}, speedup "
            f"{r['speedup']:.3f}" for r in rows["stage_pipeline"]
            if "speedup" in r))

    def elastic():
        doc = elastic_scaling.sweep(1.0, device=DEVICE)
        # the control: static once more, held to the first static run by
        # the same rule (an identical configuration's run-to-run noise)
        again = elastic_scaling._serve(
            ELASTIC_DOCS, ELASTIC_REQUESTS,
            elastic_scaling.SCENARIO.arrival.target_qps, 0, "static",
            DEVICE)
        return doc, again

    doc, again = part("elastic_scaling", elastic)
    rows["elastic_scaling"] = elastic_scaling.rows_of(doc)
    st, el, kn = doc["static"], doc["elastic"], doc["knobs"]
    errs = elastic_scaling.check(doc)
    noise = elastic_scaling.check(
        dict(doc, elastic=dict(again, deterministic_replay=True)))
    say(f"experiments (a) elastic_scaling: static goodput "
        f"{st['goodput_qps']:.4f} QPS, p99 {st['p99_ms']:.2f} ms; elastic "
        f"goodput {el['goodput_qps']:.4f} QPS, p99 {el['p99_ms']:.2f} ms "
        f"({el['n_events']} events: " + ", ".join(
            f"{e['stage']} {e['prev']}->{e['new']}" for e in el["events"])
        + f"); knobs-only at 2x load goodput {kn['goodput_qps']:.4f} QPS, "
        f"p99 {kn['p99_ms']:.2f} ms; static again goodput "
        f"{again['goodput_qps']:.4f} QPS, p99 {again['p99_ms']:.2f} ms; "
        f"elastic against static by --check's timing rule: "
        f"{errs or 'not worse'}; static again against static by the same "
        f"rule: {noise or 'not worse'}")
    if not doc["equivalent_outputs"] or not el["deterministic_replay"]:
        raise AssertionError(f"experiments (a) elastic_scaling --check: "
                             f"{errs}")
    held["elastic_scaling"] = held_live(
        "elastic_scaling", rows["elastic_scaling"],
        {**{f"elastic_scaling/{m}": {} for m in
            ("static", "elastic", "knobs")},
         "elastic_scaling/gain": {"equivalent": 1.0}})

    before = ops.launch_counts()["flash_attention"]
    points = part("gen_engine", lambda: gen_engine.sweep(1.0,
                                                         device=DEVICE))
    flash = ops.launch_counts()["flash_attention"] - before
    rows["gen_engine"] = gen_engine.rows_of(points)
    p = points[0]
    say(f"experiments (a) gen_engine at BENCH_CFG ({p['n_requests']} "
        f"requests, batch {p['batch']}, slots {p['slots']}, chunk "
        f"{p['chunk_tokens']}): offered {p['offered_qps']:.3f} QPS; "
        f"TTFT p50/p95 lock-step {p['lockstep_ttft_p50_ms']:.2f}/"
        f"{p['lockstep_ttft_p95_ms']:.2f} ms, engine "
        f"{p['engine_ttft_p50_ms']:.2f}/{p['engine_ttft_p95_ms']:.2f} ms, "
        f"p95 speedup {p['ttft_p95_speedup']:.3f}x; equivalent "
        f"{p['equivalent']}; flash_attention {flash} launches")
    errs = gen_engine.check(points)
    if errs or flash == 0:
        raise AssertionError(f"experiments (a) gen_engine --check: {errs}; "
                             f"flash_attention {flash} launches")
    held["gen_engine"] = held_live("gen_engine", rows["gen_engine"],
                                   {"gen_engine/b8s12": {"equivalent": 1}})

    for name, mod in (("scenarios", scenarios), ("chaos", chaos)):
        rows[name] = part(name, lambda: mod.run(1.0, DEVICE))
        errs = part(f"{name} --check", lambda: mod.check(device=DEVICE))
        if errs:
            raise AssertionError(f"experiments (a) {name} --check: "
                                 + "; ".join(errs))
    say(f"experiments (a) scenarios --check: "
        f"{len(rows['scenarios'])} golden variants replayed twice on the "
        f"card, each first replay equal key by key to its trace recorded "
        f"on the CPU (src/repro_torch/scenarios/golden), golden dicts and "
        f"fault logs equal, replays deterministic; chaos --check: "
        f"deterministic, lossless, recovery events verified")

    def overhead_gate():
        m = overhead.measure(GOLDEN_SCALE, OVERHEAD_RUNS, DEVICE)
        say(f"experiments (a) overhead at scale {GOLDEN_SCALE}, "
            f"{OVERHEAD_RUNS} rounds: " + row_text(overhead.row_of(m)))
        return overhead.gate(m, GOLDEN_SCALE, OVERHEAD_RUNS, DEVICE,
                             say=lambda text: say(
                                 f"experiments (a) overhead: {text}"))

    m, bad = part("overhead", overhead_gate)
    if bad:
        raise AssertionError("experiments (a) overhead --check: "
                             + "; ".join(bad))
    rows["overhead"] = [overhead.row_of(m)]
    held["overhead"] = held_live("overhead", rows["overhead"], {
        "overhead/steady": {"scale": GOLDEN_SCALE,
                            "runs": float(m["runs"])}})
    say(f"experiments (a) overhead --check: tracing within "
        f"{overhead.TOLERANCE:.0%} (throughput ratio {m['tput_ratio']:.4f}"
        f", p99 ratio {m['p99_ratio']:.4f}, {int(m['runs'])} rounds, "
        f"{int(m['n_spans'])} spans a run)")
    for name in LIVE_STUDIES + SIM_STUDIES:
        for row in rows[name]:
            say(f"experiments (a) {row_text(row)}")
    say("experiments (a): the live studies' flags and configured values "
        "held on the card: " + ", ".join(f"{k} {v}" for k, v in
                                         held.items())
        + "; wall s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return rows


def phase_experiments(torch, ops, cpu):
    """Phase 18 (module docstring): (a) the experiments on the card against
    the CPU's processes ``cpu`` (``experiments_on_cpu``), (c) the
    fused-retrieve gate, (d) the examples. Returns each kernel's launches
    in the phase and its wall seconds by part."""
    import shutil

    from repro_torch.examples import quickstart, serve_multiarch, train_e2e
    from repro_torch.experiments import common, fused_retrieve
    from repro_torch.experiments import run as experiments

    seconds = {}
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    card, walls = {}, {}
    for name, mod in experiments.MODULES.items():
        if name in LIVE_STUDIES + SIM_STUDIES:
            continue
        t1 = time.perf_counter()
        card[name] = mod.run(1.0, DEVICE)
        walls[name] = time.perf_counter() - t1
        for row in card[name]:
            say(f"experiments (a) {row_text(row)}")
    say("experiments (a): wall s on the card: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()))
    seconds["experiments (a)"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    card.update(experiments_studies(torch, ops))
    seconds["experiments (a) studies"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    errs = fused_retrieve.check(card["fused_retrieve"])
    if errs:
        raise AssertionError("experiments (c): " + "; ".join(errs))
    lat = {r["bench"]: r for r in card["fused_retrieve"]
           if "/latency_" in r["bench"]}
    say("experiments (c): fused_retrieve --check at scale 1.0 on the "
        f"card: {len(fused_retrieve.CONFIGS)} configs x 2 modes equal "
        "off by the parity rule, fresh and mutated; roofline ordered; "
        + "; ".join(f"{b}: unfused_ms {r['unfused_ms']:.4f}, fused_ms "
                    f"{r['fused_ms']:.4f}, speedup {r['speedup']:.3f}"
                    for b, r in lat.items()))

    quick = quickstart.main(["--device", DEVICE])
    served = serve_multiarch.main(["--arch", "llama3_8b", "--device",
                                   DEVICE])["llama3_8b"]
    ckpt = ROOT / "build" / "experiments_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--device", DEVICE, "--ckpt-dir", str(ckpt)]
    first = train_e2e.main(["--steps", str(E2E_STEPS // 2), *argv])
    again = train_e2e.main(["--steps", str(E2E_STEPS), *argv])
    launches = ops.launch_counts()
    shutil.rmtree(ckpt, ignore_errors=True)
    seconds["experiments (c)-(d)"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    cpu_rows = experiments_cpu_rows(*cpu)
    waited = time.perf_counter() - t1
    names = [n for group in EXPERIMENTS_ON_CPU for n in group
             if n != "quickstart"]
    compared = 0
    for name in names:
        try:
            compared += common.compare_rows(cpu_rows[name], card[name])
        except AssertionError as exc:
            raise AssertionError(f"experiments (a) {name}, the card against "
                                 f"the CPU: {exc}") from None
    say(f"experiments (a): the model-free {len(names)} on the card equal "
        f"the CPU's by common.compare_rows ({compared} counts, bytes, flags,"
        f" quality and virtual-time values, quality equal); waited "
        f"{waited:.1f} s for the CPU's processes after the card's run")

    want = cpu_rows["quickstart"]
    worst = max(abs(quick["quality"][k] - v)
                for k, v in want["quality"].items())
    loss0 = first["losses"][0]
    loss = again["losses"][E2E_STEPS - 1]
    if (quick["n_chunks"] != want["n_chunks"] or quick["queries"] == 0
            or worst != 0
            or served["n_requests"] != 8 or not all(served["answers"])
            or again["start"] != E2E_STEPS // 2 or not loss < loss0
            or not all(math.isfinite(v) for run in (first, again)
                       for v in run["losses"].values())):
        raise AssertionError(
            f"experiments (d): quickstart {quick} vs the CPU's {want}; "
            f"serve_multiarch {served}; train_e2e losses {first['losses']}"
            f", {again['losses']} (restart at {again['start']})")
    say(f"experiments (d): quickstart on the card: {quick['n_chunks']} "
        f"chunks, {quick['queries']} queries, {quick['qps']:.1f} requests/s,"
        f" quality {quick['quality']} (equal to the CPU's); "
        f"serve_multiarch --arch llama3_8b (SMOKE): ttft "
        f"{served['ttft_mean_s'] * 1e3:.2f} ms, tpot "
        f"{served['tpot_mean_s'] * 1e3:.2f} ms, generation "
        f"{100 * served['generation_frac']:.1f} % of query latency; "
        f"train_e2e {E2E_STEPS // 2} steps ({first['tok_s']:.0f} tok/s, "
        f"the first step's build included) then relaunched from its "
        f"checkpoint at step {again['start']} to {E2E_STEPS} "
        f"({again['tok_s']:.0f} tok/s): loss {loss0:.4f} at step 0, "
        f"{loss:.4f} at step {E2E_STEPS - 1}; served ttft "
        f"{again['served']['ttft_mean_s'] * 1e3:.2f} ms")
    missing = [k for k in EXPERIMENT_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"experiments: no launch of {missing}: "
                             f"{launches}")
    say(f"experiments: launches {launches}")
    seconds["experiments (a)"] += waited
    return launches, seconds


# the serving phase: scenario sims card vs CPU on the fused DB, live
# scenarios, the full-width model under closed/open/elastic load, and the
# pipelined executor
SCENARIO_DB = "torch_fused"          # ivf_topk + the freshness topk_search
LIVE_SCENARIOS = ("steady", "update_storm", "replica_failure")
# quality of a sim on the card against the CPU: equal where every request's
# retrieval agrees; each request whose ids differ inside a near tie may move
# a mean quality metric by at most 1/n_queries
SIM_QUALITY_TOL = 1e-9
# requests of the Llama-3-8B spec's serve runs (48 before the train phase
# came: cut for the whole run's time)
MODEL_REQUESTS = 24
# requests of each of phase 10's closed, open and elastic runs of the
# Llama-3-8B spec (24 before phase 18 (e) came: cut for the run's time)
MODEL_LOAD_REQUESTS = 16
# the model runs' latency SLO: an interactive answer of 16 tokens from an
# 8B generator (TTFT ~0.11 s, 15 decode steps of 40-70 ms at batch 8)
MODEL_SLO_MS = 2000.0
ELASTIC_MEM_SLACK_GIB = 2.0          # a second KV cache is ~0.52 GiB


def fused_scenario(name):
    """The registered scenario at ``golden_variant`` scale, on the fused
    DB, or for ``shard_scale`` its sharded DB with every shard on the fused
    rung (its other pipeline overrides, such as replicas, kept)."""
    from repro_torch.scenarios import golden_variant

    spec = golden_variant(name)
    pipe = json.loads(json.dumps(spec.pipeline))
    vdb = pipe.setdefault("vectordb", {})
    if vdb.get("component") == "torch_sharded":   # every shard fused
        vdb.setdefault("options", {})["use_kernel"] = "fused"
    else:
        vdb["component"] = SCENARIO_DB
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


def sim_parity(torch, ops, device, names, ref_device="cpu"):
    """The scenarios ``names`` simulated on ``device`` and on
    ``ref_device``: the timing fields and event streams equal, requests
    equal by the near-tie rule, quality within its tolerance."""
    from repro_torch.scenarios import ScenarioRunner

    out = {}
    for name in names:
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


def live_scenarios(torch, ops, device, names=LIVE_SCENARIOS):
    """``ScenarioRunner.serve()`` of the live scenarios on the fused DB:
    every request answered, except the injected kills' in
    replica_failure; the kernels launched."""
    from repro_torch.scenarios import ScenarioRunner
    from repro_torch.scenarios import runner as scenario_runner
    from repro_torch.serving.elastic import ReplicaKilled
    from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus
    from repro_torch.workload.generator import WorkloadGenerator

    harness = scenario_runner.ServingHarness
    for name in names:
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


def model_under_load(torch, ops, device, spec_path, n_requests, trace_path,
                     shares=(0.5, 0.9)):
    """The model spec served closed-loop at concurrency 8 (its rate R),
    open-loop Poisson at each share of R, and, with a ``trace_path``,
    elastic at 0.9 R with up to 2 replicas and that trace; returns each
    run's document."""
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
        eng = doc.get("engine")
        if (s["n_failed"] or sum(doc["ops"].values()) != n_requests
                or gen["n_requests"] != s["n_queries"]
                or min(launches["flash_attention"], launches["ivf_topk"],
                       launches["topk_search"]) == 0):
            raise AssertionError(f"model {name}: {s}, ops {doc['ops']}, "
                                 f"gen {gen}, launches {launches}")
        docs[name] = doc
        say(f"model{' engine' if eng else ''} {name} ({' '.join(flags)}; "
            f"{wall:.1f} s): "
            f"{int(s['n_queries'])} queries at {s['achieved_qps']:.3f} QPS"
            + (f" (offered {s['offered_qps']:.3f})" if "offered_qps" in s
               else "")
            + f", latency "
            f"p50/p95/p99 {s['p50_latency_ms']:.1f} / "
            f"{s['p95_latency_ms']:.1f} / {s['p99_latency_ms']:.1f} ms, "
            f"TTFT p50 {1e3 * gen['ttft_p50_s']:.2f} ms, TPOT p50 "
            f"{1e3 * gen['tpot_p50_s']:.2f} ms, SLO attainment "
            f"{s.get('slo_attainment', 0.0):.3f}, goodput "
            f"{s.get('goodput_qps', 0.0):.3f} QPS (SLO "
            f"{s.get('slo_ms', 0.0):.0f} ms), "
            + (f"mean batch {s['mean_batch_size']:.2f}, "
               if "mean_batch_size" in s else "")
            + f"{len(doc.get('scaling_events', []))} scale events "
            f"{doc.get('scaling_events', [])}; max_memory_allocated "
            f"{doc['peak_gib']:.2f} GiB; launches {launches}; "
            f"{int(gen['n_requests'])} generated requests"
            + (f"; engine: {int(eng['decode_steps'])} decode steps, "
               f"{int(eng['prefill_chunks'])} prefill chunks, mean active "
               f"slots per decode step {eng['mean_active_slots']:.3f}"
               if eng else ""))
        if name == "closed":
            rate = s["achieved_qps"]
            for share in shares:
                runs.append((f"open {share} R",
                             ["--mode", "open", "--arrival", "poisson",
                              "--target-qps", f"{share * rate:.4f}"]))
            if trace_path is not None:
                runs.append(("elastic 0.9 R",
                             ["--mode", "open", "--elastic",
                              "--max-replicas", "2", "--target-qps",
                              f"{0.9 * rate:.4f}", "--trace-out",
                              str(trace_path)]))
    if trace_path is None:
        return docs
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
    names = {e.get("name") for e in trace["traceEvents"]}
    want_gen = {"gen.prefill_chunk", "gen.first_token", "gen.retire"}
    if "engine" in docs["closed"] and not want_gen <= names:
        raise AssertionError(f"trace {trace_path}: no "
                             f"{sorted(want_gen - names)} instants")
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
    """The serving layer on the card (see the module docstring, phase 10)."""
    specs = SRC / "repro_torch" / "specs"
    from repro_torch.scenarios import scenario_names

    t0 = time.perf_counter()
    sim_parity(torch, ops, DEVICE, [n for n in scenario_names()
                                    if n != "shard_scale"])
    say(f"serving: sims {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    live_scenarios(torch, ops, DEVICE)
    say(f"serving: live scenarios {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    model_under_load(torch, ops, DEVICE, specs / "model_llama3_8b.json",
                     MODEL_LOAD_REQUESTS,
                     ROOT / "build" / "serving_trace.json", shares=(0.9,))
    say(f"serving: model under load {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stage_pipeline(torch, ops, DEVICE, specs / "fused_ivf.json")
    say(f"serving: stage pipeline {time.perf_counter() - t0:.1f} s")


# the limits phase: inputs off the list kernels' k, the 16-byte row unit and
# the instantiated head dims, each against its plain version, and their
# times at the main path's shapes
LIMIT_KS = (129, 500, 1024)
LIMIT_DIMS = (3, 130, 383)
LIMIT_HEAD_DIMS = (24, 80, 96, 200)
BIG_K = 500                # the large-k time at the main path's shapes
ODD_DIM = DIM - 1          # a padded width beside the main path's 384


def phase_lock_order() -> None:
    """Phase 19 (module docstring): ``scripts/lock_order.py`` in a fresh
    interpreter on the card; each graph's edges and acquisitions printed
    and checked here too."""
    from repro_torch.analysis.lockorder import LockOrderGraph

    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "lock_order.py"),
         "--device", DEVICE], capture_output=True, text=True, timeout=300)
    graphs = [json.loads(line) for line in out.stdout.splitlines()
              if line.startswith('{"lock_order"')]
    for rec in graphs:
        say(f"lock order {rec['lock_order']}: edges "
            + (", ".join(f"{a} -> {b}" for a, b in rec["edges"]) or "none")
            + "; acquisitions " + ", ".join(
                f"{k} {v}" for k, v in sorted(rec["acquisitions"].items()))
            + f"; {rec['seconds']:.2f} s")
    if out.returncode != 0:
        raise AssertionError(f"lock order: exit {out.returncode}:\n"
                             f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    if [rec["lock_order"] for rec in graphs] != ["torch", "torch_sharded"]:
        raise AssertionError(f"lock order: graphs {out.stdout[-2000:]}")
    for rec in graphs:
        g = LockOrderGraph()   # the edges replayed: a cycle raises here too
        for a, b in rec["edges"]:
            g.note_acquired(a)
            g.note_acquire_attempt(b)
            g.note_released(a)
        g.assert_acyclic()
        acq = rec["acquisitions"]
        for lock in ("elastic._lock", "vectordb._mu", "ops._COUNTS._lock"):
            if not sum(n for name, n in acq.items()
                       if name == lock or name.startswith(lock + "[")):
                raise AssertionError(f"lock order {rec['lock_order']}: "
                                     f"{lock} never taken: {acq}")


def phase_limits(torch, ops, ref, compare_topk, records) -> None:
    """Every DB kernel at k in LIMIT_KS and d in LIMIT_DIMS (and k above
    the live rows), pq_topk with a 256-subspace table, flash_attention at
    LIMIT_HEAD_DIMS, each against its plain version; then the k = BIG_K,
    d = ODD_DIM and padded head dims' times at the main path's shapes,
    added to ``records`` under ``limits``."""
    dev = torch.device(DEVICE)
    draw = draws(torch, 11)
    gen, unit, live_mask, grid = draw

    def sq8(n, d):
        x = unit(n, d)
        scale = x.abs().amax(0) / 127.0 + 1e-12
        return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale

    def pq_packed(nlist, cap_b, d, m, p_ok):
        cent = unit(nlist, d)
        ok = live_mask(nlist * cap_b, p_ok)
        codes = torch.randint(0, 256, (nlist * cap_b, m), generator=gen,
                              device=dev, dtype=torch.uint8)
        slot = torch.randperm(nlist * cap_b, generator=gen, device=dev).int()
        codebook = 0.3 * torch.randn(m, 256, d // m, generator=gen,
                                     device=dev)
        return cent, codebook, codes, slot, ok

    worst = {"max_abs_diff": 0.0, "id_mismatches": 0}

    def held(name, want, got):
        res = check(name, compare_topk(*want, *got), "plain")
        worst["max_abs_diff"] = max(worst["max_abs_diff"],
                                    res["max_abs_diff"])
        worst["id_mismatches"] += res["id_mismatches"]

    n_cases = 0
    for d in LIMIT_DIMS:
        q, v = unit(16, d), unit(20000, d)
        codes, scale = sq8(20000, d)
        qs_want = ref.quant_score(q, codes, scale)
        diff = float((ops.quant_score(q, codes, scale) - qs_want).abs().max())
        if diff > TOL:
            raise AssertionError(f"quant_score d={d}: max|d| {diff}")
        for k in (16,) + LIMIT_KS:
            # 0.02: 400 live rows, fewer than k at k >= 500
            for p in (0.9, 0.02):
                live = live_mask(20000, p)
                held(f"topk_search d={d} k={k} live={p}",
                     ref.topk_search(q, v, live, k),
                     ops.topk_search(q, v, live, k))
                held(f"sq8_topk d={d} k={k} live={p}",
                     ref.sq8_topk(q, codes, scale, live, k),
                     ops.sq8_topk(q, codes, scale, live, k))
            args = ivf_case(torch, draw, 16, 32, 256, d, 8, k, 64, 256)
            held(f"ivf_topk d={d} k={k}", ref.ivf_topk(*args),
                 ops.ivf_topk(*args))
            n_cases += 5
    # tie order at large k: grid rows (exact scores, many equal), and IVF
    # buckets whose every even row repeats in the next
    for k in LIMIT_KS:
        q, v, live = grid(6, 24), grid(5000, 24), live_mask(5000, 0.8)
        check_ties(torch, f"topk_search ties k={k}", ref.topk_search(q, v, live, k),
                    ops.topk_search(q, v, live, k))
        cent, pv, slot, ok = ivf_packed(torch, draw, 16, 256, 24, 0, 256)
        pv = grid(16 * 256, 24)
        pv[1::2] = pv[0::2]
        args = (grid(6, 24), cent, pv, slot, ok, 8, k)
        check_ties(torch, f"ivf_topk ties k={k}", ref.ivf_topk(*args),
                    ops.ivf_topk(*args))
        n_cases += 2
    # pq_topk: k above the lists' and a 256-subspace table (256 KB, past
    # shared memory): the subspaces added in the plain version's order, so
    # ids and scores are equal
    for m, d in ((PQ_M, DIM), (256, 512)):
        cent, codebook, codes, slot, ok = pq_packed(32, 256, d, m, 0.7)
        q = unit(16, d)
        for k in (16,) + LIMIT_KS:
            args = (q, codebook, cent, codes, slot, ok, 8, k)
            check_ties(torch, f"pq_topk m={m} k={k}", ref.pq_topk(*args),
                        ops.pq_topk(*args))
            n_cases += 1
    say(f"limits: {n_cases} DB kernel cases at k in {(16,) + LIMIT_KS}, d "
        f"in {LIMIT_DIMS} (and fewer live rows than k), pq_topk at m 256, "
        f"equal to the plain versions by the parity rule (max|dscore| "
        f"{worst['max_abs_diff']:.3g}; ties and PQ bit for bit)")

    # flash_attention at head dims off its instantiated widths: zero-padded
    # to the next, scored at the true dh's scale
    fa_worst = {}
    for dh in LIMIT_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
                    dtype) for shape in ((2, 8, 300, dh), (2, 2, 300, dh),
                                         (2, 2, 300, dh)))
                got = ops.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention(q, k, v, causal=causal)
                name = str(dtype).split(".")[1]
                tol = ATTN_TOL[name]
                err = float((got.float() - want.float()).abs().max())
                rel = row_rel_err(got, want)
                if (got.shape != want.shape
                        or not torch.allclose(got.float(), want.float(),
                                              rtol=tol, atol=tol)
                        or (dtype == torch.bfloat16
                            and rel > ATTN_ROW_REL_LIMIT)
                        or not bool(got.isfinite().all())):
                    raise AssertionError(f"flash_attention dh={dh} {name} "
                                         f"causal={causal}: max|d| {err}, "
                                         f"worst row {rel}")
                fa_worst[f"dh={dh} {name}"] = max(
                    fa_worst.get(f"dh={dh} {name}", 0.0), err)
    say("limits: flash_attention at " + ", ".join(
        f"{k} max|d| {v:.3g}" for k, v in fa_worst.items())
        + " (causal and not; bf16 worst rows within "
        f"{ATTN_ROW_REL_LIMIT})")

    # times at the main path's shapes: k = BIG_K beside k = K, the padded
    # width ODD_DIM beside DIM (the wrapper's pad copy included)
    q, v, live = unit(NQ, DIM), unit(N, DIM), live_mask(N, 0.99)
    held(f"topk_search N={N} k={BIG_K}", ref.topk_search(q, v, live, BIG_K),
         ops.topk_search(q, v, live, BIG_K))
    q3, v3 = q[:, :ODD_DIM].contiguous(), v[:, :ODD_DIM].contiguous()
    held(f"topk_search N={N} d={ODD_DIM}", ref.topk_search(q3, v3, live, K),
         ops.topk_search(q3, v3, live, K))
    lim = {"topk_search": {
        f"k{K}_ms": kernel_ms(lambda: ops.topk_search(q, v, live, K), torch),
        f"k{BIG_K}_ms": kernel_ms(lambda: ops.topk_search(q, v, live, BIG_K),
                                  torch),
        f"d{ODD_DIM}_ms": kernel_ms(lambda: ops.topk_search(q3, v3, live, K),
                                    torch)}}
    del v3
    codes, scale = sq8(N, DIM)
    held(f"sq8_topk N={N} k={BIG_K}",
         ref.sq8_topk(q, codes, scale, live, BIG_K),
         ops.sq8_topk(q, codes, scale, live, BIG_K))
    c3, s3 = codes[:, :ODD_DIM].contiguous(), scale[:ODD_DIM].contiguous()
    held(f"sq8_topk N={N} d={ODD_DIM}", ref.sq8_topk(q3, c3, s3, live, K),
         ops.sq8_topk(q3, c3, s3, live, K))
    lim["sq8_topk"] = {
        f"k{K}_ms": kernel_ms(lambda: ops.sq8_topk(q, codes, scale, live, K),
                              torch),
        f"k{BIG_K}_ms": kernel_ms(
            lambda: ops.sq8_topk(q, codes, scale, live, BIG_K), torch),
        f"d{ODD_DIM}_ms": kernel_ms(
            lambda: ops.sq8_topk(q3, c3, s3, live, K), torch)}
    lim["quant_score"] = {
        f"d{DIM}_ms": kernel_ms(lambda: ops.quant_score(q, codes, scale),
                                torch),
        f"d{ODD_DIM}_ms": kernel_ms(lambda: ops.quant_score(q3, c3, s3),
                                    torch)}
    del v, codes, c3
    torch.cuda.empty_cache()
    args = ivf_case(torch, draw, NQ, NLIST, CAP_B, DIM, NPROBE, K, 512, 1536)
    big = args[:6] + (BIG_K,)
    held(f"ivf_topk IVF{NLIST} k={BIG_K}", ref.ivf_topk(*big),
         ops.ivf_topk(*big))
    odd = (args[0][:, :ODD_DIM].contiguous(),
           args[1][:, :ODD_DIM].contiguous(),
           args[2][:, :ODD_DIM].contiguous()) + args[3:]
    held(f"ivf_topk IVF{NLIST} d={ODD_DIM}", ref.ivf_topk(*odd),
         ops.ivf_topk(*odd))
    lim["ivf_topk"] = {
        f"k{K}_ms": kernel_ms(lambda: ops.ivf_topk(*args), torch),
        f"k{BIG_K}_ms": kernel_ms(lambda: ops.ivf_topk(*big), torch),
        f"d{ODD_DIM}_ms": kernel_ms(lambda: ops.ivf_topk(*odd), torch)}
    del args, big, odd
    torch.cuda.empty_cache()
    cent, codebook, codes, slot, ok = pq_packed(NLIST, CAP_B, DIM, PQ_M, 0.3)
    q = torch.nn.functional.normalize(
        cent[torch.randint(NLIST, (NQ,), generator=gen, device=dev)]
        + 0.5 * unit(NQ, DIM), dim=1)
    args = (q, codebook, cent, codes, slot, ok, NPROBE)
    held(f"pq_topk IVF{NLIST},PQ{PQ_M} k={BIG_K}", ref.pq_topk(*args, BIG_K),
         ops.pq_topk(*args, BIG_K))
    lim["pq_topk"] = {
        f"k{K}_ms": kernel_ms(lambda: ops.pq_topk(*args, K), torch),
        f"k{BIG_K}_ms": kernel_ms(lambda: ops.pq_topk(*args, BIG_K), torch)}
    del codes, args
    torch.cuda.empty_cache()
    # the 256-subspace table (512-wide rows) over 256 lists of CAP_B (the
    # plain version holds the codes as int64: 2 GB here)
    cent, codebook, codes, slot, ok = pq_packed(256, CAP_B, 512, 256, 0.3)
    q = unit(NQ, 512)
    args = (q, codebook, cent, codes, slot, ok, NPROBE, K)
    held("pq_topk IVF256,PQ256 d=512", ref.pq_topk(*args),
         ops.pq_topk(*args))
    lim["pq_topk"]["m256_d512_ms"] = kernel_ms(lambda: ops.pq_topk(*args),
                                               torch)
    del codes, args
    torch.cuda.empty_cache()
    # flash_attention at the Llama-3-8B prefill shape, bf16, causal
    lim["flash_attention"] = {}
    for dh in (128,) + LIMIT_HEAD_DIMS:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((8, 32, 512, dh), (8, 8, 512, dh),
                                          (8, 8, 512, dh)))
        rel = row_rel_err(ops.flash_attention(q, k, v, causal=True),
                          ref.flash_attention(q, k, v, causal=True))
        if rel > ATTN_ROW_REL_LIMIT:
            raise AssertionError(f"flash_attention prefill dh={dh}: worst "
                                 f"row {rel}")
        lim["flash_attention"][f"dh{dh}_ms"] = kernel_ms(
            lambda: ops.flash_attention(q, k, v, causal=True), torch)
    for name, t in lim.items():
        records[name]["limits"] = t
        say(f"limits: {name} at the main path's shapes: " + ", ".join(
            f"{key[:-3]} {ms:.4f} ms" for key, ms in t.items())
            + " (back to back)")
    for name in ("topk_search", "ivf_topk", "sq8_topk"):
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           worst["max_abs_diff"])


# the engine phase: the token-level engine at Llama-3-8B's full width
ENGINE_PROMPTS = 8          # one lock-step batch (24 before the train
                            # phase came, 16 before the experiments)
# (slots, chunk_tokens, prefill_chunks_per_step, admission)
ENGINE_SETTINGS = ((8, 128, 4, "fcfs"), (3, 32, 1, "sjf"))
# requests of each engine serve run (32 before the train phase came, for
# the whole run's time)
ENGINE_LOAD_REQUESTS = 16
# experiments (e): gen_engine's point at full width, at its settings
# (batch 8, slots 12, chunk 32, 3 chunks a step, prompts to 96 tokens, 24
# new), over 24 requests (the study's 48 at scale 1.0 cut for the run's
# time)
ENGINE_FULL_REQUESTS = 24


def rag_requests(n):
    """``n`` RAG requests whose prompts (the template, a question and one
    retrieved chunk) run from 16 to 512 tokens, in a mixed order."""
    import numpy as np

    from repro_torch.core.interfaces import Chunk

    words = np.random.default_rng(0).permutation(
        np.linspace(6, 502, n).astype(int))
    questions = [f"what is the color of item-{i}" for i in range(n)]
    contexts = [[Chunk(i, i, " ".join(f"w{(i * 131 + j) % 9973}"
                                      for j in range(int(w))))]
                for i, w in enumerate(words)]
    return questions, contexts


def phase_engine(torch, ops):
    """Llama-3-8B (random bf16 weights from seed 0) through the lock-step
    ``ModelLLM`` and through ``GenEngine`` in ENGINE_SETTINGS: the same
    greedy tokens outside near ties; phase 18 (e) on its weights
    (``gen_engine_full``); then ``model_llama3_8b_engine.json`` served
    closed, open and elastic (``model_under_load``). Returns (e)'s
    flash_attention launches and wall seconds."""
    from repro_torch import configs
    from repro_torch.core.generator import ModelLLM

    cfg = configs.get_config("llama3_8b")
    llm = ModelLLM(cfg, max_prompt=512, max_new=16, batch_size=8, seed=0,
                   device=DEVICE)
    engine_matches_lockstep(torch, llm, ENGINE_SETTINGS)
    full = gen_engine_full(torch, ops, llm)
    del llm
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    model_under_load(
        torch, ops, DEVICE,
        SRC / "repro_torch" / "specs" / "model_llama3_8b_engine.json",
        ENGINE_LOAD_REQUESTS, ROOT / "build" / "engine_trace.json",
        shares=(0.9,))
    return full


def gen_engine_full(torch, ops, llm):
    """Phase 18 (e): ``gen_engine``'s point (``experiments.gen_engine.
    _point``) at full Llama-3-8B width on ``llm``'s bf16 weights, over
    ENGINE_FULL_REQUESTS requests: equivalence by the near-tie rule (bf16
    chunked prefill sums in another order than the lock-step prefill), the
    TTFT figures printed, not held. Returns flash_attention's launches in
    the point and its wall seconds."""
    import numpy as np

    from repro_torch.core.generator import ModelLLM, build_prompt
    from repro_torch.experiments import gen_engine
    from repro_torch.kernels.parity import compare_tokens

    t0 = time.perf_counter()
    model = ModelLLM(llm.cfg, max_prompt=96, max_new=24, batch_size=8,
                     device=DEVICE, model=llm.model)
    tol = LOGIT_TOL[llm.cfg.dtype]
    near, rule_launches = [], []

    def ids(answers):
        return np.array([[int(w[3:]) for w in a.split()] for a in answers])

    def near_ties(questions, want, got):
        want_ids, got_ids = ids(want), ids(got)
        if want_ids.shape != got_ids.shape:
            return False
        gaps = np.zeros(want_ids.shape)
        if (want_ids != got_ids).any():
            # the rule's own forwards are not the point's: their launches
            # are taken out of the count
            before = ops.launch_counts()["flash_attention"]
            prompts = model.tok.encode_batch(
                [build_prompt(q, []) for q in questions], model.max_prompt)
            gaps = greedy_gaps(torch, model.model, prompts,
                               np.maximum((prompts != 0).sum(1), 1),
                               want_ids)
            rule_launches.append(ops.launch_counts()["flash_attention"]
                                 - before)
        res = compare_tokens(want_ids, got_ids, gaps, tol)
        near.append(res["mismatch_rows"])
        return res["violations"] == 0

    ops.reset_launch_counts()
    p = gen_engine._point(n_req=ENGINE_FULL_REQUESTS, batch=8, slots=12,
                          chunk_tokens=32, max_prompt=96, max_new=24,
                          seed=0, device=DEVICE, llm=model, same=near_ties)
    flash = ops.launch_counts()["flash_attention"] - sum(rule_launches)
    if not p["equivalent"] or flash == 0:
        raise AssertionError(f"experiments (e): {p}; rows differing at "
                             f"near ties {near}; flash_attention {flash}")
    say(f"experiments (e): gen_engine at full width, {llm.cfg.name} "
        f"{llm.cfg.dtype} ({p['n_requests']} requests, batch {p['batch']},"
        f" slots {p['slots']}, chunk {p['chunk_tokens']}, prompts to 96 "
        f"tokens, 24 new): offered {p['offered_qps']:.4f} QPS; TTFT p50/p95"
        f" lock-step {p['lockstep_ttft_p50_ms']:.2f}/"
        f"{p['lockstep_ttft_p95_ms']:.2f} ms, engine "
        f"{p['engine_ttft_p50_ms']:.2f}/{p['engine_ttft_p95_ms']:.2f} ms; "
        f"ttft_p95_speedup {p['ttft_p95_speedup']:.4f}; walls lock-step "
        f"{p['lockstep_wall_s']:.2f} s, engine {p['engine_wall_s']:.2f} s;"
        f" rows differing only at near ties (top-2 gap <= {tol}): "
        f"offline {near[0]}, under load {near[1]} of {p['n_requests']}; "
        f"flash_attention {flash} launches (and {sum(rule_launches)} in "
        f"the rule's forwards, not counted)")
    return flash, time.perf_counter() - t0


def engine_matches_lockstep(torch, llm, settings, require=True,
                            n_prompts=ENGINE_PROMPTS):
    """``n_prompts`` RAG prompts through the lock-step ``llm`` (batch 8,
    padded to 512) and through a ``GenEngine`` on its weights in each of
    ``settings``: greedy tokens equal outside near ties of the lock-step
    logits (at the tolerance of the model's dtype). With ``require``
    false the rows that differ are counted and printed, not held: an MoE
    that drops tokens routes other groups in the two (a padded 512-token
    row against a chunk), so its outputs differ by design."""
    import numpy as np

    from repro_torch.core.generator import build_prompt
    from repro_torch.kernels.parity import compare_tokens
    from repro_torch.serving.genengine import EngineLLM, engine_from_model_llm

    name = llm.cfg.name
    questions, contexts = rag_requests(n_prompts)
    prompts = llm.tok.encode_batch([build_prompt(q, c) for q, c in
                                    zip(questions, contexts)], 512)
    lengths = np.maximum((prompts != 0).sum(1), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = np.array([[int(w[3:]) for w in a.split()]
                     for a in llm.generate(questions, contexts)])
    torch.cuda.synchronize()
    lock_s = time.perf_counter() - t0
    say(f"engine {name}: {n_prompts} prompts of {int(lengths.min())} "
        f"to {int(lengths.max())} tokens, lock-step (batch 8, padded to 512) "
        f"{lock_s:.2f} s")
    gaps = None
    for slots, chunk, budget, admission in settings:
        eng = engine_from_model_llm(llm, slots=slots, chunk_tokens=chunk,
                                    prefill_chunks_per_step=budget,
                                    admission=admission)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = np.array([[int(w[3:]) for w in a.split()] for a in
                        EngineLLM(engine=eng).generate(questions, contexts)])
        wall = time.perf_counter() - t0
        if got.shape != want.shape:
            raise AssertionError(f"engine tokens {got.shape} vs {want.shape}")
        if gaps is None and (got != want).any():
            gaps = greedy_gaps(torch, llm.model, prompts, lengths, want)
        tol = LOGIT_TOL[llm.cfg.dtype]
        res = compare_tokens(want, got, gaps if gaps is not None
                             else np.zeros(want.shape), tol)
        if res["violations"] and require:
            raise AssertionError(f"engine {slots, chunk, budget, admission}: "
                                 f"{res}")
        c = eng.counters.summary()
        held = (f"greedy tokens equal to lock-step but {res['mismatch_rows']}"
                f" rows, each explained as a near tie (reference top-2 gap "
                f"<= {tol} at its first difference)" if require else
                f"greedy tokens differ from lock-step in "
                f"{res['mismatch_rows']} rows, {res['violations']} of them "
                f"not at a near tie (top-2 gap <= {tol}): not held")
        say(f"engine {name} ({llm.cfg.dtype}, capacity factor "
            f"{llm.cfg.moe.capacity_factor if llm.cfg.moe else '-'}; slots "
            f"{slots}, chunk {chunk}, budget {budget}, {admission}): "
            f"{n_prompts} prompts in {wall:.2f} s; {held}; "
            f"{int(c['steps'])} steps, {int(c['prefill_chunks'])} prefill "
            f"chunks, {int(c['decode_steps'])} decode steps, mean active "
            f"slots {c['mean_active_slots']:.3f}; {eng.stats.n_requests} "
            f"requests recorded")
        if eng.stats.n_requests != n_prompts:
            raise AssertionError(f"engine recorded {eng.stats.n_requests}")
        del eng


# the moe phase: Qwen3-30B-A3B at full width behind the 4-shard DB
QWEN3_MOE = "qwen3_moe_30b_a3b"
# the reference's analytic counts for it (repro.configs' config through
# repro.models.api: parameters, active parameters, bytes with the routers
# in fp32)
QWEN3_MOE_PARAMS = 30_532_110_336
QWEN3_MOE_ACTIVE = 3_353_020_416
QWEN3_MOE_BYTES = 61_089_386_496
MOE_ENGINE_SETTINGS = ((8, 128, 4, "fcfs"),)
MOE_CHECK_LAYERS = 4       # the fp32 engine check's depth (12.5 GB)
MOE_SERVED_PROMPTS = 8     # the served bf16 model's engine run (24 before
                           # the train phase came)
# requests of each serve run of the moe spec (a decode step takes 75-160
# ms; fewer than the Llama runs' former 48 for the whole run's time). Not
# fewer: the stream of 12 holds no insert, so the freshness scan that
# serve_counted holds to a launch never runs
MOE_REQUESTS = 24


def phase_moe(torch, ops):
    """Qwen3-30B-A3B (random bf16 weights from seed 0) at full width on
    the card: its counts against the reference's, ``time_model``, the
    served model's engine beside lock-step on one batch of prompts (its
    drops: counted), the engine against lock-step at full width without
    drops in fp32 at 4 layers (held), then ``model_qwen3_moe_30b_a3b.json``
    served lock-step (flash_attention in every prefill layer) and closed
    under load. Returns flash_attention's launches in the lock-step serve run."""
    import dataclasses
    import gc

    from repro_torch import configs
    from repro_torch.core.generator import ModelLLM
    from repro_torch.models import api, transformer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(QWEN3_MOE)
    counts = dict(params=cfg.param_count(), active=cfg.active_param_count())
    flops = {kind: api.model_flops(cfg, 8, 512, kind)
             for kind in ("train", "prefill", "decode")}
    want_flops = {"train": 6.0 * QWEN3_MOE_ACTIVE * 8 * 512,
                  "prefill": 2.0 * QWEN3_MOE_ACTIVE * 8 * 512,
                  "decode": 2.0 * QWEN3_MOE_ACTIVE * 8}
    if (counts != dict(params=QWEN3_MOE_PARAMS, active=QWEN3_MOE_ACTIVE)
            or flops != want_flops):
        raise AssertionError(f"{QWEN3_MOE}: {counts}, {flops}")
    say(f"{QWEN3_MOE}: memory allocated before the model "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params, n_bytes = api.count_params(model), api.param_bytes(model)
    if (n_params, n_bytes) != (QWEN3_MOE_PARAMS, QWEN3_MOE_BYTES):
        raise AssertionError(f"{QWEN3_MOE}: {n_params} parameters, "
                             f"{n_bytes} bytes")
    tokens = torch.randint(4, cfg.vocab_size, (2, 64), device=DEVICE)
    with torch.inference_mode():
        logits, _ = model.prefill(tokens, model.init_cache(2, 64))
    if logits.shape != (2, cfg.vocab_size) or not bool(
            logits.float().isfinite().all()):
        raise AssertionError(f"{QWEN3_MOE} prefill logits are not finite")
    say(f"{QWEN3_MOE}: {n_params} parameters ({QWEN3_MOE_ACTIVE} active; "
        f"{n_bytes / 1e9:.2f} GB, the routers in fp32) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s, equal to the reference's counts "
        f"and model FLOPs; prefill logits finite; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del logits
    time_model(torch, model)
    # the served model (capacity factor 1.25), one batch of prompts: its
    # prefill routes each padded 512-token row as a group, the engine each
    # 128-token chunk, so they drop other tokens: counted, not held
    llm = ModelLLM(cfg, max_prompt=512, max_new=16, batch_size=8,
                   device=DEVICE, model=model)
    engine_matches_lockstep(torch, llm, MOE_ENGINE_SETTINGS, require=False,
                            n_prompts=MOE_SERVED_PROMPTS)
    say(f"{QWEN3_MOE}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del llm, model
    gc.collect()
    torch.cuda.empty_cache()
    # held: full width at MOE_CHECK_LAYERS layers in fp32 with a capacity
    # no group can fill (num_experts / top_k: every token keeps its k
    # experts), where the engine and lock-step compute one function
    m = cfg.moe
    check_cfg = cfg.replace(
        n_layers=MOE_CHECK_LAYERS, dtype="float32", moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    llm = ModelLLM(check_cfg, max_prompt=512, max_new=16, batch_size=8,
                   seed=0, device=DEVICE)
    engine_matches_lockstep(torch, llm, MOE_ENGINE_SETTINGS)
    del llm
    gc.collect()
    torch.cuda.empty_cache()

    spec = SRC / "repro_torch" / "specs" / "model_qwen3_moe_30b_a3b.json"
    launches = serve_counted(torch, ops, spec, cfg, MOE_REQUESTS)
    model_under_load(torch, ops, DEVICE, spec, MOE_REQUESTS, None, shares=())
    return launches


# the zoo phase: the families ported last, at SMOKE (card against CPU) and
# at full width (served through the RAG pipeline)
ZOO = ("qwen2_vl_72b", "whisper_large_v3", "xlstm_1_3b", "zamba2_2_7b")
# the depth each family runs at full width, every width kept: Qwen2-VL-72B
# at 16 of its 80 layers, xLSTM-1.3B at 16 of 48 (two 8-layer groups of 7
# mLSTM : 1 sLSTM), Zamba2-2.7B at 18 of 54 (three groups of 6 Mamba2
# layers and the shared block); Whisper whole. Qwen2-VL ran 32 layers and
# the others whole until the script outgrew its time limit: an xLSTM
# prefill launches ~1,560 kernels a layer, and its profiled prefill and
# served run took 82 s of the phase's 166 on the card
ZOO_LAYERS = {"qwen2_vl_72b": 16, "xlstm_1_3b": 16, "zamba2_2_7b": 18}
# the reference's parameter counts at those depths
ZOO_PARAMS = {"whisper_large_v3": 1_601_198_080,
              "xlstm_1_3b": 1_338_558_576,
              "zamba2_2_7b": 960_479_200,
              "qwen2_vl_72b": 15_288_508_416}
# flash_attention launches of one prefill batch at full width: one a layer
# (Whisper: 32 encoder + 32 decoder; Zamba2: its shared block once a group
# of 6 Mamba2 layers; xLSTM has no attention)
ZOO_FLASH = {"qwen2_vl_72b": 16, "whisper_large_v3": 64, "xlstm_1_3b": 0,
             "zamba2_2_7b": 3}
# ... and at SMOKE
ZOO_SMOKE_FLASH = {"qwen2_vl_72b": 2, "whisper_large_v3": 4,
                   "xlstm_1_3b": 0, "zamba2_2_7b": 2}
# closed loop at concurrency 8, each family (not fewer: MOE_REQUESTS), and
# time_model's runs (an xLSTM prefill ~1 s; 5 before the train phase came)
ZOO_REQUESTS = 24
ZOO_RUNS = 3
# (B, H, Hkv, S, dh, causal, window) of the new attention callers
ZOO_FLASH_SHAPES = {
    "zamba2 shared block": (1, 32, 32, 6144, 80, True, 4096),
    "whisper encoder": (8, 20, 20, 1500, 64, False, 0),
}


def visible_pairs(S, causal, window) -> int:
    """The (query, key) pairs a row-by-row attention must score: S^2, or
    S(S+1)/2 causal, each row's keys cut to ``window`` under one."""
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        total += (i + 1 if causal else S) - lo
    return total


def zoo_flash(torch, ops, ref, record):
    """flash_attention with a sliding window against its plain version:
    edge shapes in all three kernels (bf16 wgmma at dh 64/128 and 80
    padded, bf16 mma.sync at dh 32, fp32), each causal and not at every
    window, length and GQA group, elementwise and by the worst row, then the new deployment shapes
    (Zamba2's windowed shared block, Whisper's encoder) held to the
    worst-row limit with a planted fault beside it, timed against their
    bounds and SDPA, and the Llama prefill at window 0 beside phase 7's
    time. Adds the shapes to ``record``."""
    import torch.nn.functional as F

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(11)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def qkv(B, H, Hkv, S, dh, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, H, S, dh), (B, Hkv, S, dh),
                              (B, Hkv, S, dh))]

    kinds = ((128, "bfloat16"), (64, "bfloat16"), (80, "bfloat16"),
             (32, "bfloat16"), (64, "float32"), (16, "float32"))
    worst = rel_worst = 0.0
    n = 0
    for window, S, group, (dh, dt), causal in itertools.product(
            (1, 17, 64, 4096), (63, 65, 1000), (1, 4, 8), kinds,
            (True, False)):
        q, k, v = qkv(2, 8, 8 // group, S, dh, dtypes[dt])
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal,
                                  window=window).float()
        if ops.launch_counts()["flash_attention"] != 1:
            raise AssertionError("flash_attention with a window did not "
                                 "launch its kernel")
        want = ref.flash_attention(q, k, v, causal=causal,
                                   window=window).float()
        tol = ATTN_TOL[dt]
        err = float((got - want).abs().max())
        rel = row_rel_err(got, want)
        if not (bool(((got - want).abs() <= tol + tol * want.abs()).all())
                and rel <= ATTN_ROW_REL_LIMIT):
            raise AssertionError(f"flash_attention window={window} S={S} "
                                 f"group={group} dh={dh} {dt} causal="
                                 f"{causal} disagrees with plain: max|d| "
                                 f"{err}, worst row ||d||/||want|| {rel}")
        worst, rel_worst, n = max(worst, err), max(rel_worst, rel), n + 1
    say(f"zoo flash_attention: {n} windowed shapes (window 1, 17, 64, "
        f"4,096 x S 63, 65, 1,000 x GQA groups 1, 4, 8 x causal or not x "
        f"bf16 wgmma at dh 128, 64 and 80 padded, bf16 mma.sync at dh 32, "
        f"fp32 at dh 64 and 16) equal the plain version within {ATTN_TOL} "
        f"(max|d| {worst:.3g}) and worst row ||d||/||want|| {rel_worst:.3g} "
        f"(limit {ATTN_ROW_REL_LIMIT})")

    for name, (B, H, hkv, S, dh, causal, window) in ZOO_FLASH_SHAPES.items():
        q, k, v = qkv(B, H, hkv, S, dh, torch.bfloat16)
        got = ops.flash_attention(q, k, v, causal=causal,
                                  window=window).float()
        want = ref.flash_attention(q, k, v, causal=causal,
                                   window=window).float()
        tol = ATTN_TOL["bfloat16"]
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            raise AssertionError(f"flash_attention {name} disagrees with "
                                 f"plain")
        worst = max(worst, float((got - want).abs().max()))
        rel = row_rel_err(got, want)
        fault = row_rel_err(dropped_tile_attention(torch, q, k, v, causal,
                                                   window), want)
        if not rel <= ATTN_ROW_REL_LIMIT < fault:
            raise AssertionError(f"flash_attention {name}: worst row error "
                                 f"{rel} against limit "
                                 f"{ATTN_ROW_REL_LIMIT}, fault {fault}")
        del got, want
        kr, vr = (x.repeat_interleave(H // hkv, 1) for x in (k, v))
        mask = ref.attention_mask(S, causal, window, dev)
        t = timings(torch,
                    lambda: ops.flash_attention(q, k, v, causal=causal,
                                                window=window),
                    lambda: ref.flash_attention(q, k, v, causal=causal,
                                                window=window),
                    lambda: F.scaled_dot_product_attention(
                        q, kr, vr, attn_mask=mask))
        # bytes: q, k, v read once and o written once (bf16, the true dh);
        # FLOP: the two products over the pairs each row sees
        pairs = visible_pairs(S, causal, window)
        n_bytes = 2 * (2 * B * H * S * dh + 2 * B * hkv * S * dh)
        n_flop = 4.0 * B * H * pairs * dh
        bms, by = bound(n_bytes, n_flop, H100.peak_flops)
        say(f"flash_attention {name} B={B} H={H} Hkv={hkv} S={S} dh={dh} "
            f"causal={causal} window={window} bf16: worst row "
            f"||d||/||want|| {rel:.4g} (limit {ATTN_ROW_REL_LIMIT}; with one "
            f"K/V tile dropped {fault:.4g}); kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention (K/V "
            f"repeated, the mask as attn_mask) {t['library_ms']:.4f} ms, "
            f"bound {bms:.4f} ms ({by}; {n_bytes / 1e6:.1f} MB, "
            f"{n_flop / 1e9:.2f} GFLOP over {pairs} visible pairs a head); "
            f"{speed(t, bms)}")
        record["other_shapes"][name] = dict(bound_ms=bms, bound_by=by,
                                            window=window, **t)
        del q, k, v, kr, vr, mask
    record["max_abs_err"] = max(record["max_abs_err"], worst)
    B, H, hkv, S, dh, causal = FLASH_SHAPES["llm prefill"]
    q, k, v = qkv(B, H, hkv, S, dh, torch.bfloat16)
    ms0 = kernel_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                window=0), torch)
    ms = kernel_ms(lambda: ops.flash_attention(q, k, v, causal=True), torch)
    say(f"flash_attention llm prefill at window=0: {ms0:.4f} ms, without the "
        f"argument {ms:.4f} ms (phase 7 of this run: {record['ms']:.4f} ms)")
    record["llm_prefill_window0_ms"] = ms0


def zoo_smoke(torch, ops, arch, dtype):
    """One seeded SMOKE model of ``arch`` on the CPU (plain attention) and
    on the card (the kernel where the family has attention): prefill
    logits of six RAG prompts within LOGIT_TOL, flash_attention launched
    once a layer, then 8 greedy tokens equal by the near-tie rule (the vlm
    fed seeded embeddings, its frontend being a stub)."""
    import copy

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.generator import build_prompt
    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.tokenizer import HashTokenizer
    from repro_torch.kernels.parity import compare_tokens
    from repro_torch.models import api

    cfg = configs.get_smoke(arch).replace(dtype=dtype)
    tol = LOGIT_TOL[dtype]
    cpu = api.get_model(cfg).init(cfg, 0, "cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    questions = [f"what is the color of item-{i}" for i in range(6)]
    ctxs = [[Chunk(i, i, f"the color of item-{i} is shade-{i % 5} " *
                   (1 + 3 * i))] for i in range(6)]
    tokens = torch.from_numpy(HashTokenizer(cfg.vocab_size).encode_batch(
        [build_prompt(q, c) for q, c in zip(questions, ctxs)], 64))
    gen = torch.Generator().manual_seed(3)
    first, kw = tokens, {}
    if cfg.family == "vlm":
        first = torch.randn((6, 64, cfg.d_model), generator=gen)
        kw["lengths"] = torch.maximum((tokens != 0).sum(1),
                                      torch.ones((), dtype=torch.long))
    if cfg.family == "audio":
        kw["frames"] = torch.randn((6, cfg.encoder_seq, cfg.d_model),
                                   generator=gen)
    dt = next(cpu.parameters()).dtype
    if first.is_floating_point():
        first = first.to(dt)
    kw = {k: v.to(dt) if v.is_floating_point() else v for k, v in kw.items()}
    with torch.inference_mode():
        want, wc = cpu.prefill(first, cpu.init_cache(6, 80), **kw)
        ops.reset_launch_counts()
        got, gc = card.prefill(first.to(DEVICE), card.init_cache(6, 80),
                               **{k: v.to(DEVICE) for k, v in kw.items()})
        launches = ops.launch_counts()["flash_attention"]
        diff = float((got.cpu().float() - want.float()).abs().max())
        if not diff <= tol or launches != ZOO_SMOKE_FLASH[arch]:
            raise AssertionError(f"{arch} smoke {dtype} prefill: card vs CPU "
                                 f"max|d| {diff}, {launches} flash launches")
        ref_ids, ids, gaps = [], [], []
        for _ in range(8):
            top = want.float().topk(2).values
            gaps.append((top[:, 0] - top[:, 1]).numpy())
            ref_ids.append(want.argmax(-1))
            ids.append(got.argmax(-1).cpu())
            if cfg.uses_tokens:
                wi, gi = ref_ids[-1][:, None], ids[-1][:, None]
            else:
                wi = gi = torch.randn((6, 1, cfg.d_model),
                                      generator=gen).to(dt)
            want, wc = cpu.decode_step(wi, wc)
            got, gc = card.decode_step(gi.to(DEVICE), gc)
    res = compare_tokens(torch.stack(ref_ids, 1), torch.stack(ids, 1),
                         np.stack(gaps, 1), tol)
    if res["violations"]:
        raise AssertionError(f"{arch} smoke {dtype} tokens: card "
                             f"{torch.stack(ids, 1).tolist()} vs CPU "
                             f"{torch.stack(ref_ids, 1).tolist()} ({res})")
    say(f"zoo smoke {arch} ({dtype}, 6 prompts of 64): prefill logits card "
        f"vs CPU max|d| {diff:.3g} (tolerance {tol}), {launches} flash "
        f"launches; 8 greedy tokens, {res['mismatch_rows']} rows differ, "
        f"smallest CPU top-2 gap {float(np.min(gaps)):.3g}")


def zoo_config(arch):
    """The full-width config the zoo phase runs: the published one at the
    depth ZOO_LAYERS gives (every width kept)."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    if arch in ZOO_LAYERS:
        cfg = cfg.replace(n_layers=ZOO_LAYERS[arch])
    return cfg


def phase_zoo(torch, ops, ref, record):
    """The families ported last (Qwen2-VL, Whisper, xLSTM, Zamba2): the
    windowed kernel (``zoo_flash``), each SMOKE model card against CPU in
    fp32 and bf16 (``zoo_smoke``), then each at full width from seed 0 on
    the card, one at a time: its parameter count against the reference's,
    ``time_model`` and its peak memory, and ``serve_counted`` closed
    loop at concurrency 8 over ZOO_REQUESTS requests of the family's spec
    (Qwen2-VL: the Llama spec with the llm built from ``cfg``). Returns each
    family's flash_attention launches in its serve run."""
    import gc

    from repro_torch.models import api

    t0 = time.perf_counter()
    zoo_flash(torch, ops, ref, record)
    wall = {"flash": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for arch in ZOO:
        for dtype in LOGIT_TOL:
            zoo_smoke(torch, ops, arch, dtype)
    wall["SMOKE"] = time.perf_counter() - t0
    launches = {}
    for arch in ZOO:
        t_arch = time.perf_counter()
        cfg = zoo_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = api.get_model(cfg).init(cfg, seed=0, device=DEVICE)
        torch.cuda.synchronize()
        n_params, n_bytes = api.count_params(model), api.param_bytes(model)
        if n_params != ZOO_PARAMS[arch] or cfg.param_count() != n_params:
            raise AssertionError(f"{arch}: {n_params} parameters")
        say(f"zoo {arch}: {n_params} parameters ({n_bytes / 1e9:.2f} GB; "
            f"{cfg.n_layers} layers) drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s, the reference's count")
        t = time_model(torch, model, ZOO_RUNS)
        if not all(v == v and v > 0 for v in (t["prefill_ms"],
                                               t["step_ms"])):
            raise AssertionError(f"{arch}: times {t}")
        say(f"zoo {arch}: max_memory_allocated over the build and "
            f"time_model {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        spec = SRC / "repro_torch" / "specs" / (
            "model_llama3_8b.json" if arch == "qwen2_vl_72b"
            else f"model_{arch}.json")
        launches[f"model_{arch}"] = serve_counted(
            torch, ops, spec, cfg, ZOO_REQUESTS, concurrency=8,
            per_prefill=ZOO_FLASH[arch], inject_cfg=arch in ZOO_LAYERS)
        wall[arch] = time.perf_counter() - t_arch
    say("zoo: wall s: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    return launches


# the train phase: every family's step card against CPU at SMOKE (fp32),
# Phi-4-mini-3.8B trained whole on the card, a killed run restarted
TRAIN_ARCH = "phi4_mini_3_8b"
TRAIN_SEQ = 4096           # the reference's train_4k length
TRAIN_BATCH = 2            # halved (never the width) if it does not fit
TRAIN_STEPS = 5            # timed, after one warm-up step
# AdamW's rate of the full-width run, after one warm-up step. Chosen after
# H100 runs at 3e-4 and 1e-4 failed the falling-loss check (PERF.md §6).
# bf16 parameters take the update rounded (p - lr * delta, as the
# reference): at 1e-5 and |delta| <= 1 a weight of |w| >= 2^-8 keeps its
# value, so the run also prints, and holds, the share of each leaf that
# moved and the parameters' relative change
TRAIN_LR = 1e-5
# the learning-rate witness (``--lr-witness``): Phi-4-mini at full width
# and LR_WITNESS_LAYERS of its 32 layers, bf16 and fp32 parameters, the
# attention kernels and the plain attention under autograd
LR_WITNESS_LAYERS = 8
LR_WITNESS_RUNS = (("bfloat16", "kernels", 3e-4), ("bfloat16", "plain", 3e-4),
                   ("float32", "kernels", 3e-4), ("bfloat16", "kernels", 1e-5),
                   ("float32", "kernels", 1e-5))
# card against CPU, one fp32 step: loss relative; gradients and updated
# parameters elementwise (rtol, atol). The sums run in another order, and
# the fp32 attention kernels' against the plain einsums; AdamW's first
# step moves each weight by about lr * sign(g), so a gradient within its
# error of 0 moves by at most 2 lr |g| / eps-scale: atol 1e-5 on params
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = (1e-3, 1e-5)
TRAIN_PARAM_TOL = (1e-4, 1e-5)
RESTART_STEPS, RESTART_EVERY = 40, 5


def train_batch(cfg, B, S, seed, device):
    """A seeded batch: token ids and labels, a vlm's embeddings, Whisper's
    frames (numpy, then on ``device``)."""
    import numpy as np

    import torch

    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(4, cfg.vocab_size, (B, S)),
         "labels": rng.integers(4, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model))
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=dtype if v.dtype.kind == "f"
                                      else torch.long)
            for k, v in b.items()}


def train_card_equals_cpu(torch, arch):
    """One fp32 SMOKE train step of ``arch`` on the card and on the CPU
    from the same weights and batch: loss, gradients and the updated
    parameters and moments."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              train_state)

    cfg = configs.get_smoke(arch).replace(dtype="float32")
    cpu = api.get_model(cfg).init(cfg, seed=0, device="cpu")
    card = api.build(cfg, device=DEVICE)
    with torch.no_grad():
        for (_, a), (_, b) in zip(cpu.named_parameters(),
                                  card.named_parameters()):
            b.copy_(a)
    tcfg = TrainConfig()
    out = {}
    for where, model in (("cpu", cpu), (DEVICE, card)):
        state = train_state(model, tcfg)
        batch = train_batch(cfg, 2, 16, 0, where)
        params = list(state["params"].values())
        loss = api.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        state, metrics = make_train_step(cfg, tcfg)(state, batch)
        out[where] = dict(
            loss=float(metrics["loss"]), grads=[
                torch.zeros_like(p) if g is None else g.detach().cpu()
                for p, g in zip(params, grads)],
            params=[p.detach().cpu() for p in params],
            mu=[t.cpu() for t in state["opt"]["mu"].values()],
            nu=[t.cpu() for t in state["opt"]["nu"].values()])
    a, b = out["cpu"], out[DEVICE]
    rel = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    worst = {}
    for key, (rtol, atol) in (("grads", TRAIN_GRAD_TOL),
                              ("params", TRAIN_PARAM_TOL),
                              ("mu", TRAIN_GRAD_TOL), ("nu", TRAIN_GRAD_TOL)):
        worst[key] = max(float((x - y).abs().max())
                         for x, y in zip(a[key], b[key]))
        if not all(torch.allclose(y, x, rtol=rtol, atol=atol)
                   for x, y in zip(a[key], b[key])):
            raise AssertionError(f"train {arch}: {key} on the card differ "
                                 f"from the CPU's (max|d| {worst[key]})")
    if rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"train {arch}: loss {b['loss']} on the card, "
                             f"{a['loss']} on the CPU")
    return rel, worst


def host_params(state):
    """Every parameter copied to the host (what ``param_change`` compares
    against; the card's peak stays the step's own)."""
    return {n: p.detach().to("cpu", copy=True)
            for n, p in state["params"].items()}


def param_change(torch, state, before):
    """What the steps since ``before`` (``host_params``) changed: each
    leaf's share of entries whose value moved, the share over all
    entries, and ``||theta - theta_before|| / ||theta_before||`` (fp32
    sums)."""
    import math

    shares, moved, total, d2, n2 = {}, 0, 0, 0.0, 0.0
    for name, p in state["params"].items():
        b = before[name].to(p.device)
        k = int((p.detach() != b).sum())
        shares[name] = k / p.numel()
        moved, total = moved + k, total + p.numel()
        d2 += float((p.detach().float() - b.float()).square().sum())
        n2 += float(b.float().square().sum())
        del b
    return shares, moved / total, math.sqrt(d2 / n2)


def change_summary(shares, overall, rel) -> str:
    low = min(shares, key=shares.get)
    high = max(shares, key=shares.get)
    return (f"entries moved {100 * overall:.2f} % of all, by leaf "
            f"{100 * shares[low]:.3g} % ({low}) to {100 * shares[high]:.3g} % "
            f"({high}); ||dtheta|| / ||theta|| {rel:.4g}")


def train_full(torch, ops, batch_size):
    """Phi-4-mini-3.8B at full width and depth, bf16, remat full: one
    warm-up and TRAIN_STEPS timed steps through ``make_train_step`` on one
    repeated batch of ``batch_size`` x TRAIN_SEQ; returns the record (the
    loss must fall)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline.analysis import roofline_report
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    cfg = configs.get_config(TRAIN_ARCH)
    B, S = batch_size, TRAIN_SEQ
    n = cfg.param_count()
    # the peak reckoned before the run: bf16 weights and gradients, fp32
    # moments, one loss chunk's logits (fp32, its bf16 twin and gradient)
    # and every layer's saved input under remat full
    from repro_torch.models.layers import LOSS_CHUNK_ELEMS
    reckon = (12 * n + 3 * 4 * LOSS_CHUNK_ELEMS
              + cfg.n_layers * B * S * cfg.d_model * 2)
    say(f"train {cfg.name}: {n} parameters, batch {B} x {S}, bf16, remat "
        f"{cfg.remat}; reckoned peak {reckon / 1e9:.1f} GB (weights and "
        f"gradients {4 * n / 1e9:.1f}, fp32 moments {8 * n / 1e9:.1f}, one "
        f"loss chunk {12 * LOSS_CHUNK_ELEMS / 1e9:.1f}, saved layer inputs "
        f"{cfg.n_layers * B * S * cfg.d_model * 2 / 1e9:.2f})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                       total_steps=1000))
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, tcfg, DEVICE)
    torch.cuda.synchronize()
    say(f"train {cfg.name}: drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s, {api.count_params(state['model'])}"
        f" parameters")
    step = make_train_step(cfg, tcfg)
    data = synthetic_batch(DataConfig(seq_len=S, global_batch=B), cfg.vocab_size,
                           0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
    before = host_params(state)
    state, metrics = step(state, batch)          # warm-up
    losses = [float(metrics["loss"])]
    ops.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    shares, moved, rel = param_change(torch, state, before)
    del before
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    fwd_us = sum(e.self_device_time_total for e in kernels
                 if "flash_" in e.key)
    bwd_us = sum(e.self_device_time_total for e in kernels
                 if any(k in e.key for k in BWD_KERNELS))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    # the attention kernels' shares (nan where the profiler saw no device
    # time: then the step's CUDA events stand alone)
    fwd_share = fwd_us / busy if busy else float("nan")
    bwd_share = bwd_us / busy if busy else float("nan")
    del state, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = sorted(times)[len(times) // 2]
    report = roofline_report(cfg, ShapeConfig(f"train B{B} S{S}", S, B,
                                              "train"))
    bound_ms = 1e3 * max(report["compute_s"], report["memory_s"])
    mfu = api.model_flops(cfg, B, S, "train") / (step_ms / 1e3) / H100.peak_flops
    per_step = {k: launches[k] / TRAIN_STEPS
                for k in ("flash_attention", "flash_attention_bwd")}
    say(f"train {cfg.name} B={B} S={S}: step {step_ms:.1f} ms (CUDA events, "
        f"median of {TRAIN_STEPS}; {', '.join(f'{t:.1f}' for t in times)}), "
        f"{B * S / (step_ms / 1e3):.0f} tokens/s, MFU {100 * mfu:.1f} % "
        f"(model FLOPs {report['model_flops']:.4g} over the step at "
        f"{H100.peak_flops / 1e12:.0f} TFLOP/s); roofline bound "
        f"{bound_ms:.1f} ms ({report['bottleneck']}: compute "
        f"{1e3 * report['compute_s']:.1f} ms from {report['flops_per_chip']:.4g}"
        f" FLOP counted, memory {1e3 * report['memory_s']:.1f} ms from "
        f"{report['bytes_per_chip']:.4g} bytes of eager traffic, "
        f"{1e3 * report['memory_flash_s']:.1f} without [S, S] tensors); peak "
        f"{peak / 2**30:.2f} GiB; launches a step: flash_attention "
        f"{per_step['flash_attention']:g}, flash_attention_bwd "
        f"{per_step['flash_attention_bwd']:g}; device time of a profiled "
        f"step {busy / 1e3:.1f} ms, flash_attention {100 * fwd_share:.1f} "
        f"%, flash_attention_bwd {100 * bwd_share:.1f} %; top kernels "
        + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
                    for e in top)
        + f"; loss {', '.join(f'{x:.4f}' for x in losses)} at lr "
        f"{TRAIN_LR:g}; over the {1 + TRAIN_STEPS} steps "
        + change_summary(shares, moved, rel))
    if not losses[-1] < losses[1]:
        raise AssertionError(f"train {cfg.name}: the loss did not fall over "
                             f"the timed steps: {losses}")
    if min(shares.values()) == 0:
        raise AssertionError(f"train {cfg.name}: leaves the steps left "
                             f"unchanged: {[n for n, v in shares.items() if not v]}")
    if min(per_step.values()) == 0:
        raise AssertionError(f"train {cfg.name}: launches {launches}")
    return dict(batch=B, seq=S, step_ms=step_ms, step_times_ms=times,
                tokens_per_s=B * S / (step_ms / 1e3), mfu=mfu,
                bound_ms=bound_ms, roofline=report, peak_gib=peak / 2**30,
                launches=launches, device_ms=busy / 1e3,
                flash_share=fwd_share, flash_bwd_share=bwd_share,
                losses=losses, lr=TRAIN_LR, moved_share=moved,
                min_leaf_moved_share=min(shares.values()),
                rel_change=rel)


def lr_witness(torch, ops, ref):
    """``python3 chip_smoke.py --lr-witness``: Phi-4-mini at full width
    and LR_WITNESS_LAYERS layers, batch TRAIN_BATCH x TRAIN_SEQ, remat
    full, one warm-up and TRAIN_STEPS steps on the repeated batch of the
    train phase at each of LR_WITNESS_RUNS (parameters' dtype, attention
    by the kernels or the plain version under autograd, lr): the losses
    and what the steps changed. Prints; checks nothing."""
    import gc

    from repro_torch import configs
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    kernels = ops.flash_attention

    def plain(q, k, v, *, causal, window=0):
        return ref.flash_attention(q, k, v, causal=causal, window=window)

    base = configs.get_config(TRAIN_ARCH).replace(
        n_layers=LR_WITNESS_LAYERS)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    data = synthetic_batch(DataConfig(seq_len=S, global_batch=B),
                           base.vocab_size, 0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
    for dtype, attention, lr in LR_WITNESS_RUNS:
        cfg = base.replace(dtype=dtype)
        tcfg = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=1,
                                           total_steps=1000))
        ops.flash_attention = plain if attention == "plain" else kernels
        try:
            state = init_train_state(0, cfg, tcfg, DEVICE)
            step = make_train_step(cfg, tcfg)
            before = host_params(state)
            losses = []
            for _ in range(1 + TRAIN_STEPS):
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
            change = param_change(torch, state, before)
        finally:
            ops.flash_attention = kernels
        say(f"lr witness {cfg.name} at {LR_WITNESS_LAYERS} layers, {dtype} "
            f"parameters, attention by the {attention} version, lr {lr:g}: "
            f"loss {', '.join(f'{x:.4f}' for x in losses)}; "
            + change_summary(*change))
        del state, before, step
        gc.collect()
        torch.cuda.empty_cache()


def train_restart(torch):
    """``repro_torch.launch.train`` at SMOKE on the card: run A goes
    RESTART_STEPS steps uninterrupted; run B, beside it, is killed
    (SIGKILL) once its first checkpoint is written and relaunched,
    restarting from its latest checkpoint. B's last checkpoint must equal A's bit for bit."""
    import os
    import shutil

    import numpy as np

    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama3_8b", "--smoke", "--steps", str(RESTART_STEPS),
            "--ckpt-every", str(RESTART_EVERY), "--seq-len", "64",
            "--global-batch", "4", "--log-every", "0", "--device", DEVICE]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    dirs = {r: ROOT / "build" / f"train_restart_{r}" for r in "AB"}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def run(d):
        return subprocess.run(base + ["--ckpt-dir", str(d)], env=env,
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout

    # A runs beside B (each a process of its own on the card): the steps
    # are deterministic, and the two runs' start-up is most of the time
    run_a = subprocess.Popen(base + ["--ckpt-dir", str(dirs["A"])], env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
    try:
        first = dirs["B"] / f"step_{RESTART_EVERY:08d}" / "manifest.json"
        last = f"step_{RESTART_STEPS:08d}"
        proc = subprocess.Popen(base + ["--ckpt-dir", str(dirs["B"])],
                                env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 300
            while not first.exists():
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("train restart: run B ended or "
                                         "hung before its first checkpoint")
                time.sleep(0.005)
            proc.kill()
        finally:
            proc.kill()
            proc.wait()
        if (dirs["B"] / last).exists():
            raise AssertionError("train restart: run B finished before the "
                                 "kill")
        killed_at = max(int(p.name[5:]) for p in dirs["B"].glob("step_*")
                        if not p.name.endswith(".tmp"))
        out = run(dirs["B"])
        _, err = run_a.communicate(timeout=300)
    finally:
        run_a.kill()
    if run_a.returncode != 0:
        raise AssertionError(f"train restart: run A exited "
                             f"{run_a.returncode}: {err[-4000:]}")
    if f"restored checkpoint at step {killed_at}" not in out:
        raise AssertionError(f"train restart: run B did not restore step "
                             f"{killed_at}: {out}")
    a = np.load(dirs["A"] / last / "arrays.npz")
    b = np.load(dirs["B"] / last / "arrays.npz")
    diff = [k for k in a.files if not np.array_equal(a[k], b[k])]
    if sorted(a.files) != sorted(b.files) or diff:
        raise AssertionError(f"train restart: the restarted run's step "
                             f"{RESTART_STEPS} differs in {diff[:5]}")
    say(f"train restart: launch.train killed after its step {killed_at} "
        f"checkpoint and relaunched ends at step {RESTART_STEPS} equal bit "
        f"for bit to an uninterrupted run ({len(a.files)} arrays)")
    return killed_at


def phase_train(torch, ops):
    """The train phase (module docstring, phase 16); returns the Phi-4
    record and the main path's launches."""
    from repro_torch import configs

    t0 = time.perf_counter()
    worst = {}
    for arch in configs.ARCH_IDS:
        rel, w = train_card_equals_cpu(torch, arch)
        for k, v in dict(w, loss=rel).items():
            worst[k] = max(worst.get(k, 0.0), v)
    say(f"train: one fp32 step of each of the {len(configs.ARCH_IDS)} "
        f"families at SMOKE on the card equals the CPU's (loss relative "
        f"{worst['loss']:.3g}, limit {TRAIN_LOSS_TOL}; max|d| gradients "
        f"{worst['grads']:.3g}, updated parameters {worst['params']:.3g}, "
        f"mu {worst['mu']:.3g}, nu {worst['nu']:.3g})")
    t1 = time.perf_counter()
    try:
        rec = train_full(torch, ops, TRAIN_BATCH)
    except torch.cuda.OutOfMemoryError as exc:
        say(f"train: batch {TRAIN_BATCH} does not fit ({exc}); halving it")
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        rec = train_full(torch, ops, TRAIN_BATCH // 2)
    t2 = time.perf_counter()
    rec["restart_killed_at"] = train_restart(torch)
    say(f"train: wall s: SMOKE steps {t1 - t0:.1f}, {TRAIN_ARCH} "
        f"{t2 - t1:.1f}, restart {time.perf_counter() - t2:.1f}")
    return rec


# -- phase 17: the mesh ---------------------------------------------------------

MESH_RANKS = 4             # processes on the one card, joined over gloo
MESH_STEP_B, MESH_STEP_S = 4, 64     # the SMOKE step's global batch
# the sharded step against the unsharded one on the same card: relative
# loss and grad_norm, and the parameters after the step as max|d| over
# every leaf / max|p|. fp32 sums in another order (TF32 off); bf16 rounds
# each partial sum
MESH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# timed full-width sharded steps of (c) and (f), the first among them: the
# rank's CUDA, cuBLAS and gloo are warm from (a), (b) and (e), which run in
# the same process before them (after one untimed warm step until the
# experiments phase came; 2 timed before (e) and (f) joined the phase)
MESH_TRAIN_STEPS = 1
# (c)'s depth: Phi-4-mini at full width and MESH_FULL_LAYERS of its 32
# layers (all 32 until (e) and (f) joined the phase: a step took 28-43 s
# of gloo's host staging, and the script outgrew its time limit)
MESH_FULL_LAYERS = 4
# the gloo collectives probed on CUDA tensors (4 ranks on the one card)
GLOO_PROBE = ("all_reduce", "broadcast", "all_gather",
              "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single", "funcol all_gather", "funcol all_reduce",
              "funcol reduce_scatter")


def gloo_probe(torch):
    """Each gloo collective once on CUDA tensors of this rank, its result
    checked: ``{name: "ok" | the error's first line}``. Every rank raises
    at the same call when the backend lacks it, so none is left waiting."""
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    dev = torch.device(DEVICE)
    x = torch.arange(8 * n, dtype=torch.float32, device=dev).view(
        2 * n, 4) + 100 * r
    total = sum(torch.arange(8 * n, dtype=torch.float32, device=dev).view(
        2 * n, 4) + 100 * i for i in range(n))

    def run(name):
        import torch.distributed._functional_collectives as funcol

        group = dist.group.WORLD
        if name == "funcol all_gather":
            gather = getattr(funcol, "all_gather_single", None) or \
                funcol.all_gather_tensor
            out = funcol.wait_tensor(gather(x, 0, group))
            return torch.equal(out.view(n, 2 * n, 4)[n - 1],
                               x - 100 * r + 100 * (n - 1))
        if name == "funcol all_reduce":
            return torch.equal(funcol.wait_tensor(
                funcol.all_reduce(x, "sum", group)), total)
        if name == "funcol reduce_scatter":
            out = funcol.wait_tensor(funcol.reduce_scatter_tensor(
                x, "sum", 0, group))
            return torch.equal(out, total[2 * r:2 * r + 2])
        if name == "all_reduce":
            t = x.clone()
            dist.all_reduce(t)
            return torch.equal(t, total)
        if name == "broadcast":
            t = x.clone()
            dist.broadcast(t, 0)
            return torch.equal(t, x - 100 * r)
        if name == "all_gather":
            out = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(out, x)
            return all(torch.equal(o, x - 100 * r + 100 * i)
                       for i, o in enumerate(out))
        if name == "all_gather_into_tensor":
            out = torch.empty((n * 2 * n, 4), device=dev)
            dist.all_gather_into_tensor(out, x)
            return torch.equal(out.view(n, 2 * n, 4)[n - 1],
                               x - 100 * r + 100 * (n - 1))
        if name == "reduce_scatter_tensor":
            out = torch.empty((2, 4), device=dev)
            dist.reduce_scatter_tensor(out, x)
            return torch.equal(out, total[2 * r:2 * r + 2])
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return torch.equal(out[2 * (n - 1):], (x - 100 * r + 100 * (n - 1))[
            2 * r:2 * r + 2])

    found = {}
    for name in GLOO_PROBE:
        try:
            ok = run(name)
            torch.cuda.synchronize()
            found[name] = "ok" if ok else "wrong result"
        except (RuntimeError, ValueError, NotImplementedError) as exc:
            found[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
        dist.barrier()
    return found


def mesh_db(torch, rank):
    """(a): the deployment rows in a flat 4-shard DB held by every rank
    (host-side stores; rank r's card holds shard r's rows for the mesh
    scan) on mesh (data 4, model 1): 20 batches through ``search()`` on
    the mesh path; rank 0 also fills the same DB on the card (the
    ``fused`` rung: each shard's ``topk_search``) and searches it by the
    host-side merge, and holds both against the exact top-k."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.parity import compare_topk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharded import ShardedDBConfig, ShardedVectorDB

    mesh = make_mesh((MESH_RANKS, 1), ("data", "model"), "cuda", "gloo")
    data = make_rows(torch)
    cfg = ShardedDBConfig(
        n_shards=MESH_RANKS, index_type="flat", quant="none", dim=DIM,
        capacity=DB_CAPACITY, flat_capacity=FLAT_CAPACITY,
        corpus_axes=("data",))
    db = ShardedVectorDB(cfg, device="cpu")
    ids, fill = fill_db(torch, db, data)
    if rank == 0:
        say(f"mesh DB (a): filled in {fill['insert_s'] + fill['build_s']:.1f}"
            f" s; searching")
    ops.reset_launch_counts()
    times, mesh_res = [], []
    with sharding_rules(mesh):
        for q in data["batches"]:
            t0 = time.perf_counter()
            res = db.search(q.cpu().numpy(), K)
            times.append(1e3 * (time.perf_counter() - t0))
            mesh_res.append(res)
    launches = ops.launch_counts()["topk_search"]
    if rank == 0:
        say("mesh DB (a): 20 batches searched; the host-side merge next")
    out = dict(launches=launches, mesh_searches=db.counters["mesh_searches"],
               mesh_ms=times, insert_s=fill["insert_s"],
               removed=fill["removed"],
               card_mib=torch.cuda.memory_allocated() / 2**20)
    if rank == 0:
        dev = torch.device(DEVICE)
        # the same DB on the card, its shards scanned by the same kernel
        host = ShardedVectorDB(dataclasses.replace(cfg, use_kernel="fused"),
                               device=DEVICE)
        fill_db(torch, host, data)
        host_res, host_ms = search_all(torch, host, data["batches"])
        live = live_rows(torch, data)
        worst = 0.0
        for (hs, hi), res, q in zip(host_res, mesh_res, data["batches"]):
            ms_ = torch.from_numpy(np.stack([r.scores for r in res])).to(dev)
            mi = torch.from_numpy(np.stack([r.chunk_ids for r in res])).to(dev)
            got = check("mesh DB", compare_topk(hs, hi, ms_, mi),
                        "the host-side merge")
            worst = max(worst, got["max_abs_diff"])
            es, ei = exact_topk(torch, ref, data, live, ids, q)
            check("mesh DB", compare_topk(es, ei, ms_, mi), "exact top-k")
        out.update(host_ms=host_ms, max_abs_diff=worst)
        del host
    dist.barrier()
    return out


def mesh_step(torch, rank):
    """(b): the llama3 SMOKE train step on mesh (data 2, model 2) in fp32
    and bf16, against the unsharded step on rank 0, same weights (seed
    0) and batch; each rank's attention kernels counted."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import partition as pt
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    mesh = make_mesh((2, 2), ("data", "model"), "cuda", "gloo")
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = configs.get_smoke("llama3_8b").replace(dtype=dtype)
        tcfg = TrainConfig()
        b = synthetic_batch(DataConfig(seq_len=MESH_STEP_S,
                                       global_batch=MESH_STEP_B),
                            cfg.vocab_size, 0)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
        step = make_train_step(cfg, tcfg)
        with sharding_rules(mesh):
            state = init_train_state(0, cfg, tcfg, DEVICE, mesh)
            placed = pt.distribute(batch, pt.batch_specs(
                batch, mesh, MESH_STEP_B), mesh)
            ops.reset_launch_counts()
            state, m = step(state, placed)
            launches = ops.launch_counts()
            full = {n: p.full_tensor().detach()
                    for n, p in state["params"].items()}
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   launches={k: launches[k] for k in
                             ("flash_attention", "flash_attention_bwd")})
        if rank == 0:
            plain = init_train_state(0, cfg, tcfg, DEVICE)
            plain, pm = step(plain, batch)
            rec["plain_loss"] = float(pm["loss"])
            rec["plain_grad_norm"] = float(pm["grad_norm"])
            diffs = [(full[n].float() - p.detach().float()).abs()
                     for n, p in plain["params"].items()]
            # max|d| over every leaf against the largest parameter (a
            # zero-initialised norm moves by about the lr in its first
            # step, so a leaf's own scale would be the lr)
            rec["param_rel"] = max(float(d.max()) for d in diffs) / max(
                float(p.detach().float().abs().max())
                for p in plain["params"].values())
            rec["share_differing"] = sum(int((d > 0).sum()) for d in diffs
                                         ) / sum(d.numel() for d in diffs)
            tol = MESH_TOL[dtype]
            for key in ("loss", "grad_norm"):
                want = rec[f"plain_{key}"]
                if abs(rec[key] - want) > tol * abs(want):
                    raise AssertionError(f"mesh step {dtype}: {key} "
                                         f"{rec[key]} sharded, {want} not")
            if rec["param_rel"] > tol:
                raise AssertionError(f"mesh step {dtype}: parameters after "
                                     f"the step differ by {rec['param_rel']}")
        out[dtype] = rec
        dist.barrier()
    return out


# (e): every family beside the dense ones, SMOKE on (data 2, model 2)
MESH_FAMILIES = ("granite_moe_1b_a400m", "qwen3_moe_30b_a3b",
                 "whisper_large_v3", "xlstm_1_3b", "zamba2_2_7b")
MESH_DECODE = 4            # decode steps after the prefill
# (f): Granite-3.0-1B-A400M whole on (data 1, model 4)
MESH_MOE_ARCH = "granite_moe_1b_a400m"
MESH_MOE_LOSS_TOL = 1e-2   # (f)'s step-1 loss against the unsharded one


def _whole(t):
    from repro_torch.distributed.sharding import is_dtensor

    return (t.full_tensor() if is_dtensor(t) else t).detach().float()


def _rel(got, want) -> float:
    """||got - want|| / ||want|| (Frobenius)."""
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def family_serve(torch, model, cfg, mesh=None):
    """A prefill of MESH_STEP_S tokens (Whisper: and its frames) and
    MESH_DECODE decode steps on seeded tokens, the cache placed by
    ``cache_specs`` on a mesh: the logits of every step (whole) and the
    MoE routes dropped in the prefill and in the decode steps (this rank's
    experts, its groups)."""
    from repro_torch.distributed import partition as pt
    from repro_torch.models import api, moe

    g = torch.Generator(device=DEVICE).manual_seed(7)
    B, S, n = MESH_STEP_B, MESH_STEP_S, MESH_STEP_S + MESH_DECODE
    toks = torch.randint(4, cfg.vocab_size, (B, S + MESH_DECODE),
                         generator=g, device=DEVICE)
    extra = ()
    if cfg.family == "audio":
        extra = (torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=g,
                             device=DEVICE).to(model.lm_head.dtype),)
    cache = model.init_cache(B, n)
    if mesh is not None:
        cache = pt.distribute(cache, pt.cache_specs(
            api.init_cache_shape(cfg, B, n), mesh, B, n), mesh)
        toks, extra = pt.distribute((toks, extra), pt.batch_specs(
            (toks, extra), mesh, B), mesh)
    logits, drops = [], {}
    with torch.no_grad():
        with moe.count_drops() as d:
            lg, cache = model.prefill(toks[:, :S], cache, *extra)
        logits.append(_whole(lg))
        drops["prefill"] = dict(d)
        with moe.count_drops() as d:
            for i in range(MESH_DECODE):
                lg, cache = model.decode_step(toks[:, S + i:S + i + 1], cache)
                logits.append(_whole(lg))
        drops["decode"] = dict(d)
    return torch.stack(logits), drops


def mesh_family(torch, mesh, rank, arch, dtype, capacity_factor=None):
    """(e) one case: ``arch``'s SMOKE config in ``dtype`` on mesh (data 2,
    model 2), seed 0 on every rank: one train step against the unsharded
    step, a prefill and MESH_DECODE decode steps against the unsharded
    model's logits (both on rank 0), this rank's attention launches in the
    sharded step and serve run, and the MoE routes dropped."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import partition as pt
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step, shard_model)

    cfg = configs.get_smoke(arch).replace(dtype=dtype)
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    tcfg = TrainConfig()
    b = synthetic_batch(DataConfig(seq_len=MESH_STEP_S,
                                   global_batch=MESH_STEP_B),
                        cfg.vocab_size, 0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
    if cfg.family == "audio":
        g = torch.Generator(device=DEVICE).manual_seed(3)
        batch["frames"] = torch.randn((MESH_STEP_B, cfg.encoder_seq,
                                       cfg.d_model), generator=g,
                                      device=DEVICE)
    step = make_train_step(cfg, tcfg)
    t0 = time.perf_counter()
    with sharding_rules(mesh):
        state = init_train_state(0, cfg, tcfg, DEVICE, mesh)
        ops.reset_launch_counts()
        state, m = step(state, pt.distribute(batch, pt.batch_specs(
            batch, mesh, MESH_STEP_B), mesh))
        launches = ops.launch_counts()
        params = {n: _whole(p) for n, p in state["params"].items()}
        del state
        model = api.get_model(cfg).init(cfg, 0, DEVICE)
        model.requires_grad_(False)
        shard_model(model, mesh, pt.param_specs(
            dict(model.named_parameters()), mesh, cfg))
        ops.reset_launch_counts()
        logits, drops = family_serve(torch, model, cfg, mesh)
        serve_launches = ops.launch_counts()["flash_attention"]
        del model
    rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               launches={k: launches[k] for k in
                         ("flash_attention", "flash_attention_bwd")},
               serve_flash=serve_launches, drops=drops,
               seconds=time.perf_counter() - t0)
    if rank == 0:
        plain = init_train_state(0, cfg, tcfg, DEVICE)
        plain, pm = step(plain, batch)
        rec["plain_loss"] = float(pm["loss"])
        rec["plain_grad_norm"] = float(pm["grad_norm"])
        rec["param_rel"] = max(float((params[n] - p.detach().float()).abs()
                                     .max()) for n, p in
                               plain["params"].items()) / max(
            float(p.detach().float().abs().max())
            for p in plain["params"].values())
        del plain
        model = api.get_model(cfg).init(cfg, 0, DEVICE)
        want, rec["plain_drops"] = family_serve(torch, model, cfg)
        rec["logits_rel"] = _rel(logits, want)
        tol = MESH_TOL[dtype]
        for key in ("loss", "grad_norm"):
            if abs(rec[key] - rec[f"plain_{key}"]) > tol * abs(
                    rec[f"plain_{key}"]):
                raise AssertionError(f"mesh (e) {arch} {dtype}: {key} "
                                     f"{rec[key]} sharded, "
                                     f"{rec[f'plain_{key}']} not")
        if rec["param_rel"] > tol or rec["logits_rel"] > tol:
            raise AssertionError(f"mesh (e) {arch} {dtype}: parameters "
                                 f"{rec['param_rel']}, logits "
                                 f"{rec['logits_rel']} off")
    if cfg.family != "ssm" and (min(rec["launches"].values()) == 0
                                or serve_launches == 0):
        raise AssertionError(f"mesh (e) {arch} {dtype}: rank {rank} "
                             f"launches {rec['launches']}, serve "
                             f"{serve_launches}")
    dist.barrier()
    return rec


def mesh_families(torch, rank):
    """(e): every case of ``mesh_family``: the five archs in fp32 and
    bf16, then the MoE archs in fp32 at capacity factor 1 (the SMOKE
    configs' factor 8 drops no route, which would hide a routing that
    splits a group)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), "cuda", "gloo")
    cases = [(a, dt, None) for a in MESH_FAMILIES
             for dt in ("float32", "bfloat16")]
    cases += [(a, "float32", 1.0) for a in MESH_FAMILIES[:2]]
    out = {}
    for arch, dtype, cf in cases:
        out[(arch, dtype, cf)] = mesh_family(torch, mesh, rank, arch, dtype,
                                             cf)
    return out


def mesh_probe_db_step(rank):
    """The first part of a rank of phase 17: the gloo probe, (a), (b)
    and (e)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"probe": gloo_probe(torch)}
    if rank == 0:   # printed now: later parts may depend on it
        say("mesh: gloo on CUDA tensors, 4 ranks on one card: " + ", ".join(
            f"{k} {v}" for k, v in out["probe"].items())
            + " (the functional all-gather through distributed.spawn's "
              "route: gloo's coalesced all-gather reads CUDA memory from "
              "the host and crashed the ranks, PERF.md §6, PR 23)")
    out["db"] = mesh_db(torch, rank)
    out["step"] = mesh_step(torch, rank)
    t0 = time.perf_counter()
    out["families"] = mesh_families(torch, rank)
    out["families_s"] = time.perf_counter() - t0
    return out


def mesh_ranks(rank, batch_size):
    """One rank of phase 17's spawn: the gloo probe, (a), (b) and (e)
    (``mesh_probe_db_step``), then (c) and (f) at batch ``batch_size``,
    each freed before the next, with their wall seconds on this rank."""
    import gc

    import torch

    out = mesh_probe_db_step(rank)
    for key, fn in (("full", mesh_full), ("moe", mesh_moe_full)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[key] = fn(rank, batch_size)
        out[f"{key}_s"] = time.perf_counter() - t0
    return out


def mesh_full_config():
    """(c)'s config: Phi-4-mini-3.8B at full width, MESH_FULL_LAYERS
    layers."""
    from repro_torch import configs

    return configs.get_config(TRAIN_ARCH).replace(n_layers=MESH_FULL_LAYERS)


def mesh_full(rank, batch_size):
    """(c): Phi-4-mini-3.8B at full width and MESH_FULL_LAYERS layers on
    mesh (data 1, model 4), bf16, remat full, batch ``batch_size`` x
    TRAIN_SEQ (phase 16's seed, data and lr): MESH_TRAIN_STEPS steps timed
    (CUDA events), the first among them, this rank's peak memory, its
    parameter bytes against the specs' shard sizes, and its attention
    kernels' launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import partition as pt
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, MESH_RANKS), ("data", "model"), "cuda", "gloo")
    cfg = mesh_full_config()
    tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                       total_steps=1000))
    B, S = batch_size, TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    with sharding_rules(mesh):
        t0 = time.perf_counter()
        # one rank at a time: each draws the whole model before it keeps
        # its shards, and four whole copies at once would crowd the card
        # the four ranks share
        for r in range(MESH_RANKS):
            if rank == r:
                state = init_train_state(0, cfg, tcfg, DEVICE, mesh)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        init_s = time.perf_counter() - t0
        specs = pt.param_specs(state["params"], mesh, cfg)
        shard_bytes = 0
        for n, p in state["params"].items():
            shape = list(p.shape)
            for d, entry in enumerate(specs[n]):
                if entry is not None:
                    shape[d] //= MESH_RANKS
            numel = 1
            for s in shape:
                numel *= s
            shard_bytes += numel * p.element_size()
        param_bytes = sum(p.to_local().numel() * p.to_local().element_size()
                          for p in state["params"].values())
        data = synthetic_batch(DataConfig(seq_len=S, global_batch=B),
                               cfg.vocab_size, 0)
        batch = pt.distribute(
            {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()},
            pt.batch_specs(data, mesh, B), mesh)
        step = make_train_step(cfg, tcfg)
        ops.reset_launch_counts()
        losses, times = [], []
        for _ in range(MESH_TRAIN_STEPS):
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, m = step(state, batch)
            end.record()
            torch.cuda.synchronize()
            times.append((start.elapsed_time(end),
                          1e3 * (time.perf_counter() - t0)))
            losses.append(float(m["loss"]))
        launches = ops.launch_counts()
    return dict(batch=B, seq=S, init_s=init_s, step_ms=times, losses=losses,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                param_bytes=param_bytes, spec_bytes=shard_bytes,
                launches={k: launches[k] for k in
                          ("flash_attention", "flash_attention_bwd")})


def mesh_moe_full(rank, batch_size):
    """(f): Granite-3.0-1B-A400M at full width and depth on mesh (data 1,
    model 4), bf16, remat full, batch ``batch_size`` x TRAIN_SEQ (seed 0,
    phase 16's data and lr): its 32 experts split 8 a rank.
    MESH_TRAIN_STEPS steps timed (CUDA events), the first among them; this
    rank's peak memory,
    parameter bytes against the specs' shard sizes, the experts it holds,
    the routes its experts dropped in a forward of the batch (no
    gradient), and its attention kernels' launches."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import partition as pt
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, MESH_RANKS), ("data", "model"), "cuda", "gloo")
    cfg = configs.get_config(MESH_MOE_ARCH)
    tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                       total_steps=1000))
    B, S = batch_size, TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    with sharding_rules(mesh):
        t0 = time.perf_counter()
        for r in range(MESH_RANKS):   # one rank at a time, as (c)
            if rank == r:
                state = init_train_state(0, cfg, tcfg, DEVICE, mesh)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        init_s = time.perf_counter() - t0
        specs = pt.param_specs(state["params"], mesh, cfg)
        shard_bytes = 0
        for n, p in state["params"].items():
            shape = list(p.shape)
            for d, entry in enumerate(specs[n]):
                if entry is not None:
                    shape[d] //= MESH_RANKS
            numel = 1
            for size in shape:
                numel *= size
            shard_bytes += numel * p.element_size()
        param_bytes = sum(p.to_local().numel() * p.to_local().element_size()
                          for p in state["params"].values())
        experts = state["params"]["layers.0.moe.w_gate"].to_local().shape[0]
        data = synthetic_batch(DataConfig(seq_len=S, global_batch=B),
                               cfg.vocab_size, 0)
        batch = pt.distribute(
            {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()},
            pt.batch_specs(data, mesh, B), mesh)
        step = make_train_step(cfg, tcfg)
        ops.reset_launch_counts()
        losses, times = [], []
        for _ in range(MESH_TRAIN_STEPS):
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, m = step(state, batch)
            end.record()
            torch.cuda.synchronize()
            times.append((start.elapsed_time(end),
                          1e3 * (time.perf_counter() - t0)))
            losses.append(float(m["loss"]))
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad(), moe.count_drops() as drops:
            state["model"].hidden(batch["tokens"])
    return dict(batch=B, seq=S, init_s=init_s, step_ms=times, losses=losses,
                peak_gib=peak, param_bytes=param_bytes,
                spec_bytes=shard_bytes, experts=experts, drops=dict(drops),
                launches={k: launches[k] for k in
                          ("flash_attention", "flash_attention_bwd")})


def unsharded_loss(torch, cfg, batch_size):
    """The first train step of ``cfg`` unsharded on the card (seed 0, phase
    16's data and lr) at ``batch_size`` x TRAIN_SEQ, the model freed
    after: its loss and the step's peak GiB."""
    import gc

    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                       total_steps=1000))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(0, cfg, tcfg, DEVICE)
    data = synthetic_batch(DataConfig(seq_len=TRAIN_SEQ,
                                      global_batch=batch_size),
                           cfg.vocab_size, 0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
    loss = float(make_train_step(cfg, tcfg)(state, batch)[1]["loss"])
    peak = torch.cuda.max_memory_allocated() / 2**30   # this step's alone
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return loss, peak


def mesh_host_train():
    """(d): ``launch.train`` at SMOKE under ``make_host_mesh()`` (NCCL, a
    group of one), 3 steps on the card, started in the background: the
    process, whose output ``mesh_host_train_line`` reads."""
    import os
    import shutil

    ckpt = ROOT / "build" / "mesh_host_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3_8b", "--smoke", "--steps", "3", "--log-every", "1",
         "--ckpt-dir", str(ckpt)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def mesh_host_train_line(proc):
    """(d)'s last line, once its process has ended well."""
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith(
            "trained 3 steps in "):
        raise AssertionError(f"mesh host train: exit {proc.returncode}\n"
                             f"{out}\n{err[-4000:]}")
    return lines[-1]


def phase_mesh(torch, ops):
    """Phase 17 (module docstring): the unsharded steps that (c) and (f)
    are held to, in this process with (d) beside them, then four ranks on
    the one card over gloo, one spawn for the probe, (a), (b), (e), (c)
    and (f). Returns each kernel's launches on the mesh paths (summed
    over the ranks) and the phase's wall seconds."""
    import gc
    import os

    from repro_torch import configs
    from repro_torch.distributed.spawn import run_ranks

    t0 = time.perf_counter()
    host = mesh_host_train()
    try:
        want_c, _ = unsharded_loss(torch, mesh_full_config(), TRAIN_BATCH)
        t_f = time.perf_counter()
        want_f, plain_peak = unsharded_loss(
            torch, configs.get_config(MESH_MOE_ARCH), TRAIN_BATCH)
        plain_f = time.perf_counter() - t_f
    except BaseException:
        host.kill()
        raise
    host_line = mesh_host_train_line(host)
    say(f"mesh (f): {MESH_MOE_ARCH} unsharded on the card, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: step-1 loss {want_f:.6f}, peak "
        f"{plain_peak:.2f} GiB, {plain_f:.1f} s")
    say(f"mesh host (d): {host_line}")
    t_unsharded = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"mesh: before the ranks, this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved); the card "
        f"has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
    # the four ranks' caching allocators share one card: segments that
    # grow in place keep each one's reserve near what it holds (read by
    # each rank as its CUDA starts; this process's allocator is set)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(mesh_ranks, MESH_RANKS, TRAIN_BATCH,
                          store_dir=str(ROOT / "build" / "mesh_store"),
                          cuda_device=0, timeout=900)
    finally:
        del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    db = [r["db"] for r in ranks]
    if any(d["mesh_searches"] != 20 or d["launches"] < 20 for d in db):
        raise AssertionError(f"mesh DB: searches and launches "
                             f"{[(d['mesh_searches'], d['launches']) for d in db]}")
    med = sorted(sorted(d["mesh_ms"])[10] for d in db)
    say(f"mesh DB (a): {N} + {N_FRESH} rows x {DIM} fp32, flat, 4 shards on "
        f"mesh (data 4, model 1), {db[0]['removed']} rows removed; 20 "
        f"batches of {NQ} queries at k {K} through the mesh path equal the "
        f"host-side merge and the exact top-k (max|d| "
        f"{db[0]['max_abs_diff']:.3g}); mesh_searches "
        f"{[d['mesh_searches'] for d in db]}, topk_search launches by rank "
        f"{[d['launches'] for d in db]}; search() ms, gloo on one card "
        f"(4 processes): median by rank {[round(m, 3) for m in med]}, first "
        f"{[round(d['mesh_ms'][0], 1) for d in db]}; host-side merge on the "
        f"card (one process) {db[0]['host_ms']:.3f} ms; each rank's card "
        f"memory {[round(d['card_mib']) for d in db]} MiB")
    step = [r["step"] for r in ranks]
    for dtype, rec in step[0].items():
        say(f"mesh step (b) {dtype}: llama3 SMOKE on (data 2, model 2), "
            f"batch {MESH_STEP_B} x {MESH_STEP_S}: loss {rec['loss']:.6f} "
            f"against {rec['plain_loss']:.6f} unsharded, grad_norm "
            f"{rec['grad_norm']:.6f} against {rec['plain_grad_norm']:.6f}, "
            f"parameters max|d|/max|p| {rec['param_rel']:.3g} (limit "
            f"{MESH_TOL[dtype]}), {100 * rec['share_differing']:.3g} % of "
            f"their entries differing; launches by rank "
            f"{[r[dtype]['launches'] for r in step]}")
        for r in step:
            if min(r[dtype]["launches"].values()) == 0:
                raise AssertionError(f"mesh step: launches {r[dtype]}")
    fams = [r["families"] for r in ranks]
    for key, rec in fams[0].items():
        arch, dtype, cf = key
        line = (f"mesh (e) {arch} {dtype}"
                f"{'' if cf is None else f' capacity factor {cf}'}: SMOKE "
                f"on (data 2, model 2), batch {MESH_STEP_B} x {MESH_STEP_S}"
                f": loss {rec['loss']:.6f} against {rec['plain_loss']:.6f} "
                f"unsharded, grad_norm {rec['grad_norm']:.6f} against "
                f"{rec['plain_grad_norm']:.6f}, parameters max|d|/max|p| "
                f"{rec['param_rel']:.3g}, prefill + {MESH_DECODE} decode "
                f"logits ||d||/||want|| {rec['logits_rel']:.3g} (limit "
                f"{MESH_TOL[dtype]}); attention launches by rank (step) "
                f"{[f[key]['launches'] for f in fams]}, (prefill) "
                f"{[f[key]['serve_flash'] for f in fams]}; "
                f"{rec['seconds']:.1f} s")
        if cf is not None:
            line += (f"; routes dropped unsharded: prefill "
                     f"{rec['plain_drops']['prefill']['dropped']} of "
                     f"{rec['plain_drops']['prefill']['routed']}, decode "
                     f"{rec['plain_drops']['decode']['dropped']} of "
                     f"{rec['plain_drops']['decode']['routed']}; by rank "
                     f"(its experts, its groups): prefill "
                     f"{[f[key]['drops']['prefill']['dropped'] for f in fams]}"
                     f", decode "
                     f"{[f[key]['drops']['decode']['dropped'] for f in fams]}")
        say(line)
    full = [r["full"] for r in ranks]
    report_mesh_full(full, want_c)
    moe = [r["moe"] for r in ranks]
    report_mesh_moe(moe, want_f)
    wall = time.perf_counter() - t0
    t_fam, t_c, t_moe = (max(r[k] for r in ranks)
                         for k in ("families_s", "full_s", "moe_s"))
    seconds = {"mesh (a)-(d)": wall - t_fam - t_moe - plain_f,
               "mesh (e)": t_fam, "mesh (f)": t_moe + plain_f}
    say(f"mesh: wall s: unsharded (c) and (f) with (d) beside them "
        f"{t_unsharded:.1f} (of it (f)'s {plain_f:.1f}), spawn + probe + "
        f"(a) + (b) {wall - t_unsharded - t_fam - t_c - t_moe:.1f}, (c) "
        f"{t_c:.1f}, (e) {t_fam:.1f}, (f) {t_moe:.1f} on the ranks")
    launches = {"topk_search": sum(d["launches"] for d in db)}
    for k in ("flash_attention", "flash_attention_bwd"):
        launches[k] = (sum(r[dt]["launches"][k] for r in step for dt in r)
                       + sum(r["launches"][k] for r in full)
                       + sum(rec["launches"][k] for f in fams
                             for rec in f.values())
                       + sum(r["launches"][k] for r in moe))
        if k == "flash_attention":
            launches[k] += sum(rec["serve_flash"] for f in fams
                               for rec in f.values())
    return launches, seconds


def report_mesh_full(full, want):
    """(c): prints and checks the ranks' records against the unsharded
    step-1 loss ``want``."""
    rec = full[0]
    rel = abs(rec["losses"][0] - want) / abs(want)
    step_ms = [max(r["step_ms"][i][0] for r in full)
               for i in range(MESH_TRAIN_STEPS)]
    say(f"mesh full (c): {TRAIN_ARCH} at full width, {MESH_FULL_LAYERS} "
        f"layers, bf16 on (data 1, model 4), batch {rec['batch']} x "
        f"{rec['seq']}, gloo on one card: step ms (CUDA events, slowest "
        f"rank) {[round(t, 1) for t in step_ms]}, host "
        f"{[round(max(r['step_ms'][i][1] for r in full), 1) for i in range(MESH_TRAIN_STEPS)]}; "
        f"init {rec['init_s']:.1f} s; peak GiB by rank "
        f"{[round(r['peak_gib'], 2) for r in full]}; parameter bytes by rank "
        f"{[r['param_bytes'] for r in full]} against the specs' "
        f"{rec['spec_bytes']}; losses {[round(x, 4) for x in rec['losses']]}"
        f", step 1 against the unsharded {want:.6f} (relative {rel:.3g}, "
        f"limit {MESH_TOL['bfloat16']}); launches by rank "
        f"{[r['launches'] for r in full]}")
    if any(r["param_bytes"] != r["spec_bytes"] for r in full):
        raise AssertionError("mesh full: parameter bytes off the specs")
    if not rel <= MESH_TOL["bfloat16"]:
        raise AssertionError(f"mesh full: step-1 loss {rec['losses'][0]} "
                             f"against {want}")
    if any(min(r["launches"].values()) == 0 for r in full):
        raise AssertionError("mesh full: an attention kernel not launched")


def report_mesh_moe(ranks, want):
    """(f): prints and checks the ranks' records against the unsharded
    step-1 loss ``want``."""
    rec = ranks[0]
    rel = abs(rec["losses"][0] - want) / abs(want)
    step_ms = [max(r["step_ms"][i][0] for r in ranks)
               for i in range(MESH_TRAIN_STEPS)]
    say(f"mesh (f): {MESH_MOE_ARCH} FULL (24 layers, d 1,024, 32 experts "
        f"top-8, expert d_ff 512, vocab 49,155) bf16 on (data 1, model 4), "
        f"remat full, batch {rec['batch']} x {rec['seq']}, gloo on one "
        f"card: step ms (CUDA events, slowest rank) "
        f"{[round(t, 1) for t in step_ms]}, host "
        f"{[round(max(r['step_ms'][i][1] for r in ranks), 1) for i in range(MESH_TRAIN_STEPS)]}"
        f"; init {rec['init_s']:.1f} s; peak GiB by rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]}; parameter bytes by "
        f"rank {[r['param_bytes'] for r in ranks]} against the specs' "
        f"{rec['spec_bytes']}; experts held by rank "
        f"{[r['experts'] for r in ranks]}; routes dropped by rank (its "
        f"experts, a forward of the batch) "
        f"{[(r['drops']['dropped'], r['drops']['routed']) for r in ranks]}"
        f"; losses {[round(x, 4) for x in rec['losses']]}, step 1 against "
        f"the unsharded {want:.6f} (relative {rel:.3g}, limit "
        f"{MESH_MOE_LOSS_TOL}); attention launches by rank "
        f"{[r['launches'] for r in ranks]}")
    if any(r["param_bytes"] != r["spec_bytes"] for r in ranks):
        raise AssertionError("mesh (f): parameter bytes off the specs")
    if any(r["experts"] != 32 // MESH_RANKS for r in ranks):
        raise AssertionError("mesh (f): experts not split over the ranks")
    if not rel <= MESH_MOE_LOSS_TOL:
        raise AssertionError(f"mesh (f): step-1 loss {rec['losses'][0]} "
                             f"against {want}")
    if any(min(r["launches"].values()) == 0 for r in ranks):
        raise AssertionError("mesh (f): an attention kernel not launched")


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir() or H100 is None:
        raise SystemExit("chip_smoke.py runs from the root of a checkout "
                         "(src/repro_torch not found)")
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

    if sys.argv[1:] == ["--lr-witness"]:
        lr_witness(torch, ops, ref)
        say(card)
        return 0

    # phase 18's CPU half, beside the build (its cores are partly idle)
    cpu_experiments = experiments_on_cpu()
    t0 = time.perf_counter()
    reports = _build.build_all()
    say(f"build: {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    # shared memory per block each launcher requests, at the main path's
    # row widths and k (flash_attention: the Hopper kernel at dh 128 and 64)
    widths = {"topk_search": [DIM], "ivf_topk": [DIM],
              "quant_score": [DIM, 768, 1024],
              "sq8_topk": [DIM, 768, 1024], "pq_topk": [PQ_M],
              "flash_attention": [128, 64], "flash_attention_bwd": [128, 64],
              "topk_large": [DIM]}
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
    db_launches, unsharded = phase_dbs(torch, ops, ref, compare_topk)
    timings["dbs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_launches = phase_sharded(torch, ops, ref, compare_topk,
                                     unsharded)
    timings["sharded"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serve(torch, ops)
    timings["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records["flash_attention"] = phase_flash(torch, ops, ref)
    timings["flash kernel"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records["flash_attention_bwd"] = phase_flash_bwd(torch, ops, ref)
    timings["flash bwd"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_model_smoke(torch, ops)
    timings["model smoke"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash_launches, (fig5_launches, fig5_s) = phase_model_full(
        torch, ops, lambda model: experiments_fig5(torch, ops, model))
    timings["model full width"] = time.perf_counter() - t0 - fig5_s
    timings["experiments (b)"] = fig5_s
    torch.cuda.empty_cache()
    experiment_launches, experiment_seconds = phase_experiments(
        torch, ops, cpu_experiments)
    for k, v in fig5_launches.items():
        experiment_launches[k] += v
    timings.update(experiment_seconds)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serving(torch, ops)
    timings["serving"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_lock_order()
    timings["lock order"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_limits(torch, ops, ref, compare_topk, records)
    timings["limits"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine_flash_launches, timings["experiments (e)"] = phase_engine(
        torch, ops)
    timings["engine"] = (time.perf_counter() - t0
                         - timings["experiments (e)"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = phase_train(torch, ops)
    timings["train"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_launches, mesh_seconds = phase_mesh(torch, ops)
    timings.update(mesh_seconds)
    t0 = time.perf_counter()
    moe_flash_launches = phase_moe(torch, ops)
    timings["moe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo_flash_launches = phase_zoo(torch, ops, ref,
                                   records["flash_attention"])
    timings["zoo"] = time.perf_counter() - t0
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
        # each path's launches, its counts set to 0 just before it
        if name == "flash_attention":
            rec["launches_by_path"] = {"model_llama3_8b": flash_launches,
                                       "experiments":
                                           experiment_launches[name],
                                       "experiments (e)":
                                           engine_flash_launches,
                                       "model_qwen3_moe_30b_a3b":
                                           moe_flash_launches,
                                       **zoo_flash_launches,
                                       f"train_{TRAIN_ARCH}":
                                           train["launches"][name],
                                       "mesh": mesh_launches[name]}
        elif name == "flash_attention_bwd":
            rec["launches_by_path"] = {
                f"train_{TRAIN_ARCH}": train["launches"][name],
                "mesh": mesh_launches[name],
                "experiments": experiment_launches[name]}
            rec["train"] = {k: v for k, v in train.items()
                            if k not in ("launches", "roofline")}
        else:
            rec["launches_by_path"] = {
                "dbs": db_launches[name],
                "sharded": sharded_launches.get(name, 0),
                "mesh": mesh_launches.get(name, 0),
                "experiments": experiment_launches[name]}
        rec["launches"] = sum(rec["launches_by_path"].values())
        kernels.append(rec)
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
