"""End-to-end example: train a small LM on the RAG corpus for a few hundred
steps (deterministic data pipeline, AdamW, periodic async checkpoints,
restart-from-latest), then plug the trained model into the serving path
(the port of ``examples/train_e2e.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e [--steps 200] [--device cpu]

A relaunch restores the latest checkpoint under ``--ckpt-dir`` (default
``build/ckpt_train_e2e`` in the checkout) and trains on from it. On the card
the step's attention runs through the ``flash_attention`` kernel and its
gradient through ``flash_attention_bwd`` (fp32, head dim 64), the served
prefill through ``flash_attention``. The same code path drives the full
configs (``python -m repro_torch.launch.train --arch llama3_8b
--production-mesh``).
"""
import argparse
import time
from pathlib import Path

from repro_torch import resolve_device, synchronize
from repro_torch.core.generator import ModelLLM
from repro_torch.core.registry import build
from repro_torch.core.spec import PipelineSpec
from repro_torch.launch.train import device_batch
from repro_torch.models.config import ModelConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import CorpusDataSource, DataConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus

# <repo>/build: src/repro_torch/examples/train_e2e.py -> parents[3]
CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt_train_e2e"

CFG = ModelConfig(name="rag-lm-20m", family="dense", n_layers=4,
                  d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
                  vocab_size=8192, activation="swiglu", rope_type="rope",
                  remat="none", dtype="float32")


def serve(model, corpus, device, n_questions: int = 4):
    """The trained model as the RAG pipeline's generator: index the corpus,
    answer ``n_questions`` questions; returns the generator's stats."""
    llm = ModelLLM(CFG, max_prompt=128, max_new=4, batch_size=4,
                   device=device, model=model)
    pipe = build(PipelineSpec(retrieve_k=4, rerank_k=2), llm=llm,
                 device=device)
    pipe.index_documents(corpus.all_documents())
    questions = [f"what is the {corpus.facts[d][0].attribute} of "
                 f"{corpus.facts[d][0].subject}?" for d in range(n_questions)]
    traces = pipe.query(questions)
    return {**llm.stats.summary(), "answers": [t.answer for t in traces]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CFG
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    corpus = SyntheticCorpus(CorpusConfig(n_docs=256))
    dcfg = DataConfig(source="corpus", seq_len=128, global_batch=8)
    data = CorpusDataSource(corpus, dcfg, cfg.vocab_size)

    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=20,
                                       total_steps=args.steps))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    state = init_train_state(0, cfg, tcfg, device)
    restored, start = ckpt.restore_latest(state)
    if restored is not None:
        print(f"restarting from checkpoint at step {start}")
    else:
        start = 0

    step_fn = make_train_step(cfg, tcfg)
    losses = {}
    synchronize(device)
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        state, metrics = step_fn(state, device_batch(data.batch(s), cfg,
                                                     device))
        if s % 20 == 0 or s == args.steps - 1:
            losses[s] = float(metrics["loss"])
            print(f"step {s:4d} loss={losses[s]:.4f} "
                  f"lr={float(metrics['lr']):.2e}")
        if (s + 1) % 100 == 0:
            ckpt.save(state, s + 1)              # async write
    ckpt.save(state, args.steps, blocking=True)
    synchronize(device)
    wall = time.perf_counter() - t0
    tok = (args.steps - start) * dcfg.global_batch * dcfg.seq_len
    tok_s = tok / wall if tok else 0.0
    print(f"{tok_s:.0f} tok/s over {args.steps - start} steps")
    print(f"checkpoints: {ckpt.list_checkpoints()} in {args.ckpt_dir}")

    served = serve(state["model"], corpus, device)
    print(f"served: ttft={served['ttft_mean_s'] * 1e3:.1f}ms "
          f"tpot={served['tpot_mean_s'] * 1e3:.1f}ms over "
          f"{served['n_requests']:.0f} requests")
    return {"start": start, "steps": args.steps, "losses": losses,
            "tok_s": tok_s, "wall_s": wall, "state": state,
            "checkpoints": ckpt.list_checkpoints(), "served": served}


if __name__ == "__main__":
    main()
