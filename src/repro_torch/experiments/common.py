"""Shared experiment harness utilities: the port of ``benchmarks/common.py``.

Every experiment exposes ``run(scale, device) -> list[dict]`` rows and
prints them as ``benchmark,metric,value`` CSV. ``scale`` shrinks
corpus/request counts so the full suite stays cheap; the shapes of the
curves (the paper's findings) are preserved.

All experiments construct pipelines through one helper: ``default_spec``
maps the shared experiment defaults (+ per-experiment overrides in the
reference's legacy ``PipelineConfig`` knob names, which the port does not
have) onto a declarative ``PipelineSpec`` with the port's ``torch`` vector
DB, and ``build_pipeline`` builds it via the component registry on
``device``: the same path the serving CLI uses.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.interfaces import BaseLLM
from repro_torch.core.pipeline import RAGPipeline
from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec, StageSpec
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus

# the reference's legacy PipelineConfig knobs and their defaults
# (src/repro/core/pipeline.py:30-56)
LEGACY_DEFAULTS: Dict[str, Any] = dict(
    embedder="hash", embed_dim=384, chunk_method="separator",
    chunk_size=512, chunk_overlap=0, index_type="ivf", quant="none",
    nlist=64, nprobe=8, capacity=1 << 16, use_hybrid=True,
    flat_capacity=4096, rebuild_threshold=0.75, use_kernel=False,
    reranker="overlap", retrieve_k=16, rerank_k=4, llm="extractive",
    llm_arch="", llm_smoke=True, gen_batch=8, max_new_tokens=16)

# the one place the ad-hoc per-experiment knob soup lives
BENCH_DEFAULTS = dict(
    embedder="hash", index_type="ivf", nlist=16, nprobe=8,
    capacity=1 << 15, retrieve_k=8, rerank_k=3, flat_capacity=1024)


def emit(rows: List[Dict]) -> None:
    for r in rows:
        bench = r.pop("bench")
        for k, v in r.items():
            if isinstance(v, float):
                print(f"{bench},{k},{v:.6g}")
            else:
                print(f"{bench},{k},{v}")
    sys.stdout.flush()


def make_corpus(n_docs: int, modality: str = "text", seed: int = 0
                ) -> SyntheticCorpus:
    return SyntheticCorpus(CorpusConfig(n_docs=n_docs, modality=modality,
                                        seed=seed))


def default_spec(**overrides) -> PipelineSpec:
    """Experiment defaults + legacy-knob overrides, as a ``PipelineSpec``:
    the reference's ``PipelineSpec.from_config`` over ``LEGACY_DEFAULTS``
    overridden by ``BENCH_DEFAULTS`` and ``overrides`` (an unknown knob
    raises), with the port's ``torch`` vector DB."""
    unknown = sorted(set(overrides) - set(LEGACY_DEFAULTS))
    if unknown:
        raise TypeError(f"unknown pipeline knob(s) {unknown}")
    cfg = {**LEGACY_DEFAULTS, **BENCH_DEFAULTS, **overrides}
    llm_opts: Dict[str, Any] = {}
    if cfg["llm"] == "model":
        llm_opts = {"arch": cfg["llm_arch"], "smoke": cfg["llm_smoke"],
                    "batch_size": cfg["gen_batch"],
                    "max_new": cfg["max_new_tokens"]}
    return PipelineSpec(
        embedder=StageSpec(cfg["embedder"], {"dim": cfg["embed_dim"]}),
        chunker=StageSpec(cfg["chunk_method"],
                          {"size": cfg["chunk_size"],
                           "overlap": cfg["chunk_overlap"]}),
        vectordb=StageSpec("torch", {
            "index_type": cfg["index_type"], "quant": cfg["quant"],
            "dim": cfg["embed_dim"], "capacity": cfg["capacity"],
            "nlist": cfg["nlist"], "nprobe": cfg["nprobe"],
            "use_hybrid": cfg["use_hybrid"],
            "flat_capacity": cfg["flat_capacity"],
            "rebuild_threshold": cfg["rebuild_threshold"],
            "use_kernel": cfg["use_kernel"]}),
        reranker=StageSpec(cfg["reranker"]),
        llm=StageSpec(cfg["llm"], llm_opts, batch_size=cfg["gen_batch"]),
        retrieve_k=cfg["retrieve_k"], rerank_k=cfg["rerank_k"])


def build_pipeline(corpus: Optional[SyntheticCorpus] = None,
                   llm: Optional[BaseLLM] = None, index: bool = True,
                   device="cuda", **overrides) -> RAGPipeline:
    """Build (and by default index) the shared experiment pipeline on
    ``device``.

    ``llm`` substitutes a pre-built generation backend (experiments share
    one expensive model across configs); ``overrides`` are legacy knobs
    applied on top of ``BENCH_DEFAULTS``.
    """
    pipe = build(default_spec(**overrides), llm=llm, device=device)
    if corpus is not None and index:
        pipe.index_documents(corpus.all_documents())
    return pipe


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


# How two runs of the experiments agree, key by key (``compare_rows``):
# counts, sizes, bytes, flags, labels and the roofline's byte model equal;
# quality within the caller's tolerance; the shard sweep's virtual-time
# numbers within SIM_TOL; every other key is a measurement of its run
# (finite, not negative; a rate, a total or a latency positive). The
# serving studies have rules of their own, by bench (``rule``), because one
# key name means two things there (``goodput_qps`` is virtual time in a
# scenario's row and the wall clock's in a live one)
EXACT_KEYS = frozenset({
    "chunks", "index_bytes", "vector_bytes", "rebuilds", "shards",
    "corpus_scale", "imbalance", "output_identical", "exact_built",
    "exact_mutated", "mode", "index_type", "quant", "bound_bytes",
    "fused_bytes", "unfused_bytes", "fused_bound_fraction",
    "unfused_bound_fraction", "bytes_saved_ratio", "nq", "n", "d", "k",
    "nlist", "cap_b", "nprobe"})
QUALITY_KEYS = frozenset({
    "context_recall_retrieved", "context_recall", "f1", "exact",
    "factual_consistency", "recall", "recall_single"})
SIM_KEYS = frozenset({"p99_latency_ms", "p95_latency_ms", "slo_attainment",
                      "goodput_qps"})
SIM_TOL = 1e-9
POSITIVE_KEYS = frozenset({"qps", "total_s", "baseline_s", "monitored_s",
                           "search_s", "search_single_s", "unfused_ms",
                           "fused_ms", "speedup"})
# the monitor's rows (resource_utilization's): samples of its run, each a
# measurement; a gauge's row exists only where one of its 20 ms samples
# landed while the experiment ran (``db_live`` only after it was added),
# so it may be missing from one run
MONITOR_ROWS = "resource_utilization/"
SAMPLED_ROWS = frozenset(
    MONITOR_ROWS + g for g in ("host_rss_bytes", "cpu_util", "io_read_Bps",
                               "io_write_Bps", "torch_device_bytes",
                               "db_live"))
# the simulator's rows (scenarios, chaos): wall-clock free, so every key is
# held: counts and event numbers equal, quality by the quality rule, the
# virtual-time latencies and rates within SIM_TOL
SIM_BENCHES = ("scenarios/", "chaos/")
SIM_COUNT_KEYS = frozenset({
    "n_requests", "n_scaling_events", "n_knob_moves", "deterministic",
    "n_failed", "n_retried", "n_faults_injected", "n_respawns",
    "n_retires"})
SIM_QUALITY_KEYS = frozenset({"quality_goodput_qps", "quality_weight"})
# the live serving studies' rows: measurements of their run (coalescing,
# autoscale events and span counts follow the wall clock too), but for the
# flags, the configured sizes and the samples a seeded stream fixes;
# ``serving``'s offered load and concurrency are its configured values
LIVE_BENCHES = ("serving_", "stage_pipeline/", "elastic_scaling/",
                "gen_engine/", "overhead/")
LIVE_EXACT_KEYS = frozenset({"equivalent", "deterministic", "runs", "scale",
                             "n_samples_off", "n_samples_on"})
SERVING_SET_KEYS = frozenset({"offered_qps", "concurrency"})
# a live row's throughputs are positive (goodput may be 0: a loaded host
# can miss every SLO)
LIVE_POSITIVE_KEYS = frozenset({
    "achieved_qps", "offered_qps", "lockstep_qps", "samebatch_qps",
    "pipelined_qps", "tput_off_qps", "tput_on_qps", "speedup",
    "ttft_p95_speedup"})


def rule(bench: str, key: str) -> str:
    """How ``compare_rows`` holds ``key`` of row ``bench``: ``exact``,
    ``quality``, ``sim`` (within SIM_TOL) or ``measured``."""
    if bench.startswith(SIM_BENCHES):
        if key in SIM_COUNT_KEYS:
            return "exact"
        return "quality" if key in SIM_QUALITY_KEYS else "sim"
    if bench.startswith(LIVE_BENCHES):
        if key in LIVE_EXACT_KEYS or (bench.startswith("serving_")
                                      and key in SERVING_SET_KEYS):
            return "exact"
        return "measured"
    if bench.startswith(MONITOR_ROWS):
        return "measured"
    if key in EXACT_KEYS:
        return "exact"
    if key in QUALITY_KEYS:
        return "quality"
    return "sim" if key in SIM_KEYS else "measured"


def compare_rows(want: List[Dict], got: List[Dict],
                 quality_tol: float = 0.0) -> int:
    """Hold ``got``'s rows against ``want``'s by ``rule``: the same
    ``bench`` names (but for sampled gauge rows) and keys in the same order.
    Raises AssertionError at the first disagreement; returns the number of
    values held (the measurements not counted)."""
    unmatched = {r["bench"] for r in want} ^ {r["bench"] for r in got}
    if not unmatched <= SAMPLED_ROWS:
        raise AssertionError(f"rows in one run only: "
                             f"{sorted(unmatched - SAMPLED_ROWS)}")
    want = [r for r in want if r["bench"] not in unmatched]
    got = [r for r in got if r["bench"] not in unmatched]
    if [r["bench"] for r in got] != [r["bench"] for r in want]:
        raise AssertionError(f"rows differ: {[r['bench'] for r in got]} "
                             f"vs {[r['bench'] for r in want]}")
    n = 0
    for w, g in zip(want, got):
        bench = g["bench"]
        if list(g) != list(w):
            raise AssertionError(f"{bench}: keys {list(g)} vs {list(w)}")
        live = bench.startswith(LIVE_BENCHES)
        for key, wv in w.items():
            gv = g[key]
            if key == "bench":
                continue
            how = rule(bench, key)
            if how == "measured":
                ok = math.isfinite(gv) and gv >= 0 and (gv > 0 or key not in (
                    LIVE_POSITIVE_KEYS if live else POSITIVE_KEYS))
            elif how == "exact":
                ok = gv == wv
            elif how == "quality":
                ok = abs(gv - wv) <= quality_tol
            else:
                ok = abs(gv - wv) <= SIM_TOL
            n += how != "measured"
            if not ok:
                raise AssertionError(f"{bench}: {key} {gv!r} against "
                                     f"{wv!r}")
    return n
