"""Serve the RAG pipeline with different generation backbones (--arch),
exactly the paper's model-swap experiment (§5.2): the pipeline is untouched,
only the BaseLLM backend changes (the port of
``examples/serve_multiarch.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_multiarch
    PYTHONPATH=src python -m repro_torch.examples.serve_multiarch --arch zamba2_2_7b

On the card each backbone's prefill attention runs through the
``flash_attention`` kernel.
"""
import argparse

from repro_torch import configs, resolve_device
from repro_torch.core.generator import ModelLLM
from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec, StageSpec
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus

# the reference's PipelineConfig(retrieve_k=4, rerank_k=2): every other
# knob at its default
SPEC = PipelineSpec(
    vectordb=StageSpec("torch", {
        "index_type": "ivf", "quant": "none", "dim": 384,
        "capacity": 1 << 16, "nlist": 64, "nprobe": 8, "use_hybrid": True,
        "flat_capacity": 4096, "rebuild_threshold": 0.75}),
    llm=StageSpec("extractive", batch_size=8),
    retrieve_k=4, rerank_k=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    archs = [args.arch] if args.arch else ["llama3_8b", "qwen3_moe_30b_a3b",
                                           "xlstm_1_3b"]
    corpus = SyntheticCorpus(CorpusConfig(n_docs=32))
    questions = [f"what is the {corpus.facts[d][0].attribute} of "
                 f"{corpus.facts[d][0].subject}?" for d in range(8)]
    out = {}
    for arch in archs:
        # the reduced same-family config, as the reference serves it here
        llm = ModelLLM(configs.get_smoke(arch), max_prompt=96, max_new=4,
                       batch_size=4, device=device)
        pipe = build(SPEC, llm=llm, device=device)
        pipe.index_documents(corpus.all_documents())
        traces = pipe.query(questions)
        bd = pipe.breakdown()
        gen_frac = bd["generation"] / max(sum(
            bd.get(s, 0.0) for s in
            ("query_embed", "retrieval", "rerank", "generation")), 1e-9)
        s = llm.stats.summary()
        print(f"{arch:22s} ttft={s['ttft_mean_s'] * 1e3:7.1f}ms "
              f"tpot={s['tpot_mean_s'] * 1e3:6.1f}ms "
              f"generation={100 * gen_frac:4.1f}% of query latency")
        out[arch] = {**s, "generation_frac": gen_frac,
                     "answers": [t.answer for t in traces]}
    return out


if __name__ == "__main__":
    main()
