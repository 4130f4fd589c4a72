"""Paper Fig. 6: indexing-stage breakdown (chunk / embed / insert / build)
per modality (text, pdf, code, audio) and per index scheme (the port of
``benchmarks/indexing_breakdown.py``).

The transformer embedder returns its vectors on the host, and the pipeline
waits for the DB's device work at the end of the insertion and build
stages, so each stage's host-clock time includes its device time.
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.experiments.common import build_pipeline, emit, make_corpus


def run(scale: float = 1.0, device="cuda"):
    device = resolve_device(device)
    rows = []
    n_docs = max(int(48 * scale), 8)
    for modality in ("text", "pdf", "code", "audio"):
        corpus = make_corpus(n_docs, modality=modality)
        pipe = build_pipeline(corpus, device=device)
        bd = pipe.breakdown()
        rows.append({
            "bench": f"indexing_breakdown/{modality}",
            "chunking_s": bd.get("chunking", 0.0),
            "embedding_s": bd.get("embedding", 0.0),
            "insertion_s": bd.get("insertion", 0.0),
            "index_build_s": bd.get("index_build", 0.0),
            "chunks": pipe.db.stats()["live"],
        })
    # transformer embedder = the compute-heavy conversion stage
    corpus = make_corpus(max(n_docs // 4, 4))
    pipe = build_pipeline(corpus, device=device, embedder="transformer",
                          embed_dim=64)
    bd = pipe.breakdown()
    rows.append({
        "bench": "indexing_breakdown/text-transformer-embed",
        "embedding_s": bd.get("embedding", 0.0),
        "insertion_s": bd.get("insertion", 0.0),
        "index_build_s": bd.get("index_build", 0.0),
    })
    return rows


if __name__ == "__main__":
    emit(run())
