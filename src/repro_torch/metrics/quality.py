"""Quality metrics (paper §3.4): context recall, query accuracy, factual
consistency.

The paper scores these with Ragas (LLM-as-judge).  Offline we compute them
*exactly* against the synthetic corpus's known ground truth (DESIGN.md §2
assumption 4) — deterministic and reproducible, which an LLM judge is not:

  context recall      — fraction of queries whose gold chunk(s) appear in the
                        retrieved (or reranked) context;
  query accuracy      — token-F1 between generated answer and ground truth
                        (exact-match also reported);
  factual consistency — fraction of answer tokens supported by the retrieved
                        context (the claim-support analogue: an answer copied
                        from context scores 1, a hallucinated one 0).
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.interfaces import StageTrace
from repro_torch.core.tokenizer import HashTokenizer

_tok = HashTokenizer()


def _f1(pred: str, truth: str) -> float:
    p, t = _tok.words(pred), _tok.words(truth)
    if not p or not t:
        return float(p == t)
    common = set(p) & set(t)
    if not common:
        return 0.0
    prec = len(common) / len(set(p))
    rec = len(common) / len(set(t))
    return 2 * prec * rec / (prec + rec)


def context_recall(traces: Sequence[StageTrace], stage: str = "reranked"
                   ) -> float:
    """Fraction of queries whose gold chunks were in the context."""
    scored = [t for t in traces if t.gold_chunk_ids]
    if not scored:
        return 0.0
    hits = 0
    for t in scored:
        ids = set(t.reranked_ids if stage == "reranked" else t.retrieved_ids)
        if ids & set(t.gold_chunk_ids):
            hits += 1
    return hits / len(scored)


def query_accuracy(traces: Sequence[StageTrace]) -> Dict[str, float]:
    scored = [t for t in traces if t.ground_truth]
    if not scored:
        return {"f1": 0.0, "exact": 0.0}
    f1 = sum(_f1(t.answer, t.ground_truth) for t in scored) / len(scored)
    em = sum(t.answer.strip().lower() == t.ground_truth.strip().lower()
             for t in scored) / len(scored)
    return {"f1": f1, "exact": em}


def factual_consistency(traces: Sequence[StageTrace],
                        get_chunk_text) -> float:
    """Fraction of answer tokens present in the retrieved context."""
    scored = [t for t in traces if t.answer]
    if not scored:
        return 0.0
    total = 0.0
    for t in scored:
        ctx_words: set = set()
        for cid in (t.reranked_ids or t.retrieved_ids):
            text = get_chunk_text(cid)
            if text:
                ctx_words |= set(_tok.words(text))
        ans = _tok.words(t.answer)
        if not ans:
            continue
        total += sum(w in ctx_words for w in ans) / len(ans)
    return total / len(scored)


def trace_quality(trace: StageTrace) -> float:
    """Per-request quality weight in [0, 1] for quality-aware goodput.

    The mean of the two axes the serving knob ladder degrades: whether the
    gold chunk survived into the (possibly ``nprobe``/``rerank_k``-reduced)
    context, and token-F1 of the (possibly ``max_new``-shortened) answer
    against ground truth.  A request with no gradable ground truth weighs 1
    (nothing to price), so the weight only ever *discounts* goodput.
    """
    parts = []
    if trace.gold_chunk_ids:
        ids = set(trace.reranked_ids or trace.retrieved_ids)
        parts.append(1.0 if ids & set(trace.gold_chunk_ids) else 0.0)
    if trace.ground_truth:
        parts.append(_f1(trace.answer, trace.ground_truth))
    return sum(parts) / len(parts) if parts else 1.0


def mean_quality_weight(traces: Sequence[StageTrace]) -> float:
    """Mean per-request quality weight (1.0 for an empty trace list)."""
    if not traces:
        return 1.0
    return sum(trace_quality(t) for t in traces) / len(traces)


def evaluate_traces(traces: Sequence[StageTrace], db=None) -> Dict[str, float]:
    out: Dict[str, float] = {
        "context_recall_retrieved": context_recall(traces, "retrieved"),
        "context_recall": context_recall(traces, "reranked"),
        **query_accuracy(traces),
    }
    if db is not None:
        out["factual_consistency"] = factual_consistency(
            traces, lambda cid: (db.get_chunk(cid).text
                                 if db.get_chunk(cid) else ""))
    return out
