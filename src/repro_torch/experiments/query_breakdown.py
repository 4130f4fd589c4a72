"""Paper Fig. 5: end-to-end query latency breakdown per pipeline stage,
across vector-db configs and generation-model sizes (the port of
``benchmarks/query_breakdown.py``).

Every stage's output reaches the host before its timer stops (the DB's
search results, ``ModelLLM``'s tokens after its synchronise), so the host
clock of ``StageTimer`` times the device's work too.
"""
from __future__ import annotations

from repro_torch import configs, resolve_device
from repro_torch.core.generator import ModelLLM
from repro_torch.experiments.common import build_pipeline, emit, make_corpus

QUERY_STAGES = ("query_embed", "retrieval", "rerank", "generation")


def questions_for(corpus, n_q: int):
    return [f"what is the {f.attribute} of {f.subject}?"
            for d in range(n_q) for f in corpus.facts[d][:1]]


def model_pipeline(corpus, questions, llm, device):
    """The generation-model axis's pipeline around ``llm``, after it has
    answered ``questions[:4]``."""
    # explicit overrides keep this axis on its historical config (bare
    # PipelineConfig defaults), not the shared BENCH_DEFAULTS
    pipe = build_pipeline(corpus, llm=llm, device=device, capacity=1 << 14,
                          nlist=64, retrieve_k=16, rerank_k=4,
                          flat_capacity=4096)
    pipe.query(questions[:4])
    return pipe


def model_row(name: str, pipe):
    """One row of the generation-model axis from its pipeline's stages."""
    bd = pipe.breakdown()
    gen = bd.get("generation", 0.0)
    total = sum(bd.get(s, 0.0) for s in QUERY_STAGES)
    return {
        "bench": f"query_breakdown/model-{name}",
        "generation_s": gen,
        "generation_frac": gen / total if total else 0.0,
        "total_s": total,
    }


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    rows = []
    n_docs = max(int(32 * scale), 8)
    n_q = max(int(16 * scale), 4)
    corpus = make_corpus(n_docs)
    questions = questions_for(corpus, n_q)

    # vector-db axis (paper: LanceDB/Milvus/... -> our index families)
    for index_type, quant in [("flat", "none"), ("flat", "sq8"),
                              ("ivf", "none"), ("ivf", "pq")]:
        pipe = build_pipeline(corpus, device=device, index_type=index_type,
                              quant=quant)
        pipe.query(questions)
        bd = pipe.breakdown()
        total = sum(bd.get(s, 0.0) for s in QUERY_STAGES)
        rows.append({
            "bench": f"query_breakdown/{index_type}-{quant}",
            "query_embed_s": bd.get("query_embed", 0.0),
            "retrieval_s": bd.get("retrieval", 0.0),
            "rerank_s": bd.get("rerank", 0.0),
            "generation_s": bd.get("generation", 0.0),
            "total_s": total,
        })

    # generation-model axis (paper: Qwen7B/GPT20B/Qwen72B -> smoke backbones)
    for arch in ("llama3_8b", "qwen3_moe_30b_a3b"):
        llm = ModelLLM(configs.get_smoke(arch), max_prompt=64, max_new=4,
                       batch_size=4, device=device)
        rows.append(model_row(arch, model_pipeline(corpus, questions, llm,
                                                   device)))
    return rows


if __name__ == "__main__":
    emit(run())
