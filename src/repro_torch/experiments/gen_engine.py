"""Lock-step vs token-level continuous-batching generation (the engine
experiment; the port of ``benchmarks/gen_engine.py``).

Drives the *same* random-weight model through two generation schedulers
under one bursty, mixed-prompt-length arrival stream:

* ``lockstep`` — ``ModelLLM``: requests queue FIFO, a batch prefills
  together and decodes in lock-step for ``max_new`` steps; a request
  arriving mid-batch waits for the whole batch to finish (head-of-line
  blocking at request-batch granularity);
* ``engine`` — ``GenEngine``: newly arrived requests are admitted into free
  KV-cache slots at every decode step, prompts prefill in chunks between
  decode steps, sequences retire per-slot.

Per-request TTFT is anchored at each request's *arrival* (queue wait
included — that is where continuous batching wins; the RAG trade-offs study
arXiv 2412.11854 shows generation dominates end-to-end latency, and RAGO
arXiv 2503.14649 that prefill/decode scheduling drives its tail).  The
offered load is self-calibrated from the measured capacity of both
backends so the comparison is about scheduling, not about saturating either
backend.

``--check`` asserts (a) the engine's outputs are identical to lock-step for
the same admission order and (b) engine TTFT p95 beats lock-step on the
bursty mixed-length workload.  ``python -m repro_torch.experiments.gen_engine
--smoke --device cpu`` emits JSON.

``_point`` also takes a prebuilt ``ModelLLM`` (a full-width model, say)
and an equivalence rule over the two schedulers' answers, for models whose
two prefill paths sum in different orders (bf16 chunked prefill against the
lock-step prefill), where equal tokens hold only outside near ties.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.generator import ModelLLM, build_prompt, render_tokens
from repro_torch.models.config import ModelConfig
from repro_torch.serving.accounting import percentile
from repro_torch.serving.arrival import ArrivalConfig, arrival_times
from repro_torch.serving.genengine import EngineLLM, engine_from_model_llm

# Sized so one prefill chunk costs milliseconds of real matmul work on a
# CPU: at smoke scale (d=128) dispatch overhead hides the pad-prefill waste
# that request-level batching pays; at d=384/float32 the compute dominates
# and the schedulers are compared on the work they actually schedule.
BENCH_CFG = ModelConfig(
    name="genengine-bench", family="dense", n_layers=2, d_model=384,
    n_heads=8, n_kv_heads=4, d_ff=768, vocab_size=2048,
    dtype="float32", remat="none")

# an equivalence rule: (questions, lock-step answers, engine answers) -> ok
Rule = Callable[[List[str], List[str], List[str]], bool]


def equal_answers(questions: List[str], want: List[str],
                  got: List[str]) -> bool:
    """The reference's rule: the answer strings equal."""
    return got == want


def _prompts(n: int, seed: int = 0) -> List[str]:
    """Mixed prompt lengths: short chat-like questions interleaved with
    long stuffed-context questions (the regime where request-level batching
    padding + head-of-line blocking hurt most)."""
    rng = np.random.default_rng(seed)
    words = [f"entity{i}" for i in range(64)]
    out = []
    for i in range(n):
        n_words = int(rng.choice([6, 12, 48, 72], p=[0.4, 0.2, 0.2, 0.2]))
        body = " ".join(rng.choice(words, size=n_words))
        out.append(f"what is the value of {body}")
    return out


def _run_lockstep(llm: ModelLLM, texts: List[str], arrivals: np.ndarray
                  ) -> Dict[str, List[float]]:
    """FIFO request-batch serving loop: wait for >=1 arrived request, take up
    to ``batch_size`` arrived ones, serve them as one lock-step batch."""
    n, bs = len(texts), llm.batch_size
    t0 = time.perf_counter()
    arr = t0 + arrivals
    ttft, answers = [0.0] * n, [""] * n
    i = 0
    while i < n:
        now = time.perf_counter()
        if arr[i] > now:
            time.sleep(arr[i] - now)
            now = arr[i]
        j = i
        while j < n and j - i < bs and arr[j] <= now:
            j += 1
        before = len(llm.stats.ttft_s)
        t_start = time.perf_counter()
        out = llm.generate(texts[i:j], [[] for _ in range(j - i)])
        # one batch == one prefill: every member's first token lands at
        # t_start + service-TTFT; queue wait is t_start - arrival
        svc_ttft = llm.stats.ttft_s[before]
        for r in range(i, j):
            ttft[r] = (t_start - arr[r]) + svc_ttft
            answers[r] = out[r - i]
        i = j
    return {"ttft_s": ttft, "answers": answers,
            "wall_s": time.perf_counter() - t0}


def _run_engine(eng, texts: List[str], arrivals: np.ndarray
                ) -> Dict[str, List[float]]:
    """Real-time continuous-batching loop: submit at each arrival instant,
    step the engine continuously."""
    n = len(texts)
    t0 = time.perf_counter()
    arr = t0 + arrivals
    rids, submitted = [], 0
    while submitted < n or eng.busy():
        now = time.perf_counter()
        while submitted < n and arr[submitted] <= now:
            rids.append(eng.submit(texts[submitted],
                                   t_arrive=arr[submitted]))
            submitted += 1
        if not eng.step() and submitted < n:
            time.sleep(max(0.0, arr[submitted] - time.perf_counter()))
    recs = [eng.records.pop(r) for r in rids]
    return {"ttft_s": [r.ttft_s for r in recs],
            "answers": [render_tokens(r.out) for r in recs],
            "wall_s": time.perf_counter() - t0}


def _point(n_req: int, batch: int, slots: int, chunk_tokens: int,
           max_prompt: int, max_new: int, seed: int = 0, device="cuda",
           llm: Optional[ModelLLM] = None,
           same: Rule = equal_answers) -> Dict[str, object]:
    """One comparison point on ``llm`` (default: a fresh ``BENCH_CFG``
    model from ``seed`` on ``device``, at these sizes), its equivalence
    decided by ``same``."""
    if llm is None:
        llm = ModelLLM(BENCH_CFG, max_prompt=max_prompt, max_new=max_new,
                       batch_size=batch, seed=seed, device=device)
    questions = _prompts(n_req, seed)
    # the prompt text both schedulers actually tokenize (BaseLLM.generate
    # applies the same template internally)
    texts = [build_prompt(p, []) for p in questions]

    # offline equivalence (cold passes: the first call of each path's
    # shapes): same admission order => identical outputs
    ref = llm.generate(questions, [[] for _ in questions])
    eng_llm = EngineLLM(engine=engine_from_model_llm(
        llm, slots=slots, chunk_tokens=chunk_tokens,
        prefill_chunks_per_step=3))
    eng_out = eng_llm.generate(questions, [[] for _ in questions])
    equivalent = same(questions, ref, eng_out)

    # warm capacity measurement (clones share the weights)
    t0 = time.perf_counter()
    llm.generate(questions, [[] for _ in questions])
    lock_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng_llm.engine.clone().run(texts)
    eng_wall = time.perf_counter() - t0

    # self-calibrated offered load: ~half the *slower* backend's measured
    # offline capacity.  Neither scheduler is saturated, so TTFT is decided
    # by scheduling alone: lock-step makes an arrival wait out the in-flight
    # batch's full decode (head-of-line blocking), the engine admits it into
    # a free slot at the next token step and prefills it in chunks.
    cap_qps = n_req / max(lock_wall, eng_wall, 1e-6)
    qps = 0.5 * cap_qps
    arrivals = arrival_times(ArrivalConfig(
        process="bursty", target_qps=qps, n_requests=n_req,
        burst_cycle_s=0.6, burst_duty=0.5, seed=seed))

    lock = _run_lockstep(llm, questions, arrivals)
    engine = _run_engine(eng_llm.engine.clone(), texts, arrivals)
    same_under_load = same(questions, lock["answers"], engine["answers"])

    def ms(xs, q):
        return 1e3 * percentile(xs, q)

    return {
        "n_requests": n_req, "batch": batch, "slots": slots,
        "chunk_tokens": chunk_tokens, "offered_qps": qps,
        "equivalent": bool(equivalent and same_under_load),
        "lockstep_ttft_p50_ms": ms(lock["ttft_s"], 50),
        "lockstep_ttft_p95_ms": ms(lock["ttft_s"], 95),
        "engine_ttft_p50_ms": ms(engine["ttft_s"], 50),
        "engine_ttft_p95_ms": ms(engine["ttft_s"], 95),
        "ttft_p95_speedup": (percentile(lock["ttft_s"], 95)
                             / max(percentile(engine["ttft_s"], 95), 1e-9)),
        "lockstep_wall_s": lock["wall_s"], "engine_wall_s": engine["wall_s"],
    }


def sweep(scale: float = 1.0, seed: int = 0,
          device="cuda") -> List[Dict[str, object]]:
    device = resolve_device(device)
    n_req = max(32, int(48 * scale))
    # decode-dominant service (max_new 24): the regime the RAG trade-offs
    # study (arXiv 2412.11854) identifies as typical — and where lock-step
    # head-of-line blocking costs a full batch-decode per arrival
    return [_point(n_req=n_req, batch=8, slots=12, chunk_tokens=32,
                   max_prompt=96, max_new=24, seed=seed, device=device)]


def check(points: List[Dict[str, object]]) -> List[str]:
    """``--check``'s assertions; returns human-readable failures."""
    failures = []
    for p in points:
        if not p["equivalent"]:
            failures.append("continuous batching changed outputs vs "
                            "lock-step")
        if not p["engine_ttft_p95_ms"] < p["lockstep_ttft_p95_ms"]:
            failures.append(
                f"no TTFT p95 win: engine {p['engine_ttft_p95_ms']:.1f}ms "
                f"vs lockstep {p['lockstep_ttft_p95_ms']:.1f}ms")
    return failures


def rows_of(points: List[Dict[str, object]]) -> List[Dict]:
    """A sweep's points as ``run``'s rows."""
    return [{"bench": f"gen_engine/b{p['batch']}s{p['slots']}",
             "equivalent": int(p["equivalent"]),
             "offered_qps": p["offered_qps"],
             "lockstep_ttft_p95_ms": p["lockstep_ttft_p95_ms"],
             "engine_ttft_p95_ms": p["engine_ttft_p95_ms"],
             "ttft_p95_speedup": p["ttft_p95_speedup"]} for p in points]


def run(scale: float = 1.0, device="cuda") -> List[Dict]:
    """``experiments.run`` entry point: engine-vs-lockstep rows."""
    return rows_of(sweep(scale, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small request count; JSON to stdout")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--check", action="store_true",
                    help="assert output equivalence and a TTFT p95 win")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="optional JSON output path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scale = 0.7 if args.smoke else args.scale
    points = sweep(scale, seed=args.seed, device=args.device)
    doc = {"sweep": points}
    text = json.dumps(doc, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    if args.check:
        failures = check(points)
        if failures:
            raise AssertionError("; ".join(failures))
        print("CHECK OK: outputs equivalent, "
              f"TTFT p95 speedup {points[0]['ttft_p95_speedup']:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
