"""Generation stage (paper §3.3.4): the port of ``repro.core.generator``.

``ModelLLM`` is the lock-step baseline: batched prefill fills the KV cache,
then a greedy decode loop emits tokens. TTFT / TPOT are recorded **per
request**; the rows that pad a batch to ``batch_size`` are never counted.
The decode runs with *per-row* positions, so a row's output depends only
on its own unpadded prompt. Weights are random (drawn
from a seed on the device), so the output is for performance, not quality.

``ExtractiveLLM`` is the deterministic quality oracle: it answers from the
retrieved context with template matching.
"""
from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import require_same_device, resolve_device
from repro_torch.core.interfaces import BaseLLM, Chunk
from repro_torch.core.registry import register
from repro_torch.core.tokenizer import HashTokenizer
from repro_torch.models import api
from repro_torch.models.config import ModelConfig

PROMPT_TEMPLATE = ("answer the question using the context\n"
                   "context: {context}\nquestion: {question}\nanswer:")

def build_prompt(question: str, contexts: Sequence[Chunk]) -> str:
    ctx = " ".join(c.text for c in contexts)
    return PROMPT_TEMPLATE.format(context=ctx, question=question)


def render_tokens(ids: Sequence[int]) -> str:
    """The shared id->text rendering for random-weight generation output
    (the hash tokenizer has no decoder)."""
    return " ".join(f"tok{t}" for t in ids)


@dataclass
class GenStats:
    """Per-request generation metrics, safe under concurrent recording.

    Replicated generate-stage workers (``ElasticExecutor`` pools) share one
    ``GenStats``: every mutation happens under the internal lock, so no
    sample is lost when two replicas record at once.  Only *real* requests
    are recorded: batch-padding rows never reach ``record``."""

    ttft_s: List[float] = field(default_factory=list)   # guarded-by: _lock
    tpot_s: List[float] = field(default_factory=list)   # guarded-by: _lock
    tokens_out: int = 0                                 # guarded-by: _lock
    n_requests: int = 0                                 # guarded-by: _lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def record(self, ttft_s: float, tpot_s: float, tokens: int) -> None:
        """Record one completed request (thread-safe)."""
        with self._lock:
            self.ttft_s.append(float(ttft_s))
            self.tpot_s.append(float(tpot_s))
            self.tokens_out += int(tokens)
            self.n_requests += 1

    def merge(self, other: "GenStats") -> None:
        """Fold another stats object in (per-engine stats at summary time)."""
        with other._lock:
            ttft, tpot = list(other.ttft_s), list(other.tpot_s)
            tokens, n = other.tokens_out, other.n_requests
        with self._lock:
            self.ttft_s.extend(ttft)
            self.tpot_s.extend(tpot)
            self.tokens_out += tokens
            self.n_requests += n

    def summary(self) -> Dict[str, float]:
        """The reference's summary keys, plus ``tpot_p50_s``."""
        with self._lock:
            ttft, tpot = list(self.ttft_s), list(self.tpot_s)
            tokens, n = self.tokens_out, self.n_requests
        return {
            "ttft_mean_s": float(np.mean(ttft)) if ttft else 0.0,
            "tpot_mean_s": float(np.mean(tpot)) if tpot else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else 0.0,
            "tpot_p50_s": float(np.percentile(tpot, 50)) if tpot else 0.0,
            "tpot_p95_s": float(np.percentile(tpot, 95)) if tpot else 0.0,
            "tokens_out": float(tokens),
            "n_requests": float(n),
        }


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the reference's
    ``block_until_ready``) before a clock is read. It waits for the whole
    device, so under several generation replicas a replica's TTFT and TPOT
    include the work the others queued meanwhile."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ModelLLM(BaseLLM):
    """Batched prefill + KV-cache greedy decode over a dense architecture.

    ``model`` replaces the seeded draw (``repro_torch.convert`` passes the
    reference's weights this way); it must lie on ``device``. ``stats``
    shares one ``GenStats`` between generators."""

    def __init__(self, cfg: ModelConfig, max_prompt: int = 256,
                 max_new: int = 16, batch_size: int = 8, seed: int = 0,
                 device=None, model=None, stats: Optional[GenStats] = None):
        self.cfg = cfg
        family = api.get_model(cfg)
        self.device = resolve_device(device)
        self.model = (model if model is not None
                      else family.init(cfg, seed, self.device))
        require_same_device("ModelLLM", self.model, self.device)
        self.max_prompt = max_prompt
        self.max_new = max_new
        self._max_new_cap = max_new
        self.batch_size = batch_size
        self.tok = HashTokenizer(cfg.vocab_size)
        self.stats = stats if stats is not None else GenStats()

    def clone(self) -> "ModelLLM":
        """A replica view for pool workers: shares the model (the same
        weight tensors, never a second draw) and the thread-safe stats;
        per-call state (the KV cache) is already local to a call."""
        twin = object.__new__(ModelLLM)
        twin.__dict__.update(self.__dict__)
        return twin

    def set_max_new(self, n: int) -> int:
        """Autoscale knob: clamp decode length to [1, configured max]."""
        self.max_new = max(1, min(int(n), self._max_new_cap))
        return self.max_new

    def generate(self, prompts: Sequence[str],
                 contexts: Sequence[Sequence[Chunk]]) -> List[str]:
        out: List[str] = []
        bs = self.batch_size
        for lo in range(0, len(prompts), bs):
            chunk_p = prompts[lo:lo + bs]
            chunk_c = contexts[lo:lo + bs]
            texts = [build_prompt(p, c) for p, c in zip(chunk_p, chunk_c)]
            tokens = self.tok.encode_batch(texts, self.max_prompt)
            if len(texts) < bs:   # pad the batch dim to a fixed shape
                tokens = np.pad(tokens, ((0, bs - len(texts)), (0, 0)))
            out.extend(self._generate_batch(tokens, n_real=len(texts)))
        return out

    @torch.inference_mode()
    def _generate_batch(self, tokens: np.ndarray, n_real: int) -> List[str]:
        """Generate for one padded batch; only the first ``n_real`` rows are
        real requests — they alone are timed, counted and returned."""
        B = tokens.shape[0]
        max_new = self.max_new
        dev = self.device
        cache = self.model.init_cache(B, self.max_prompt + max_new)
        t0 = time.perf_counter()
        tok = torch.from_numpy(tokens).to(dev)
        # per-row true prompt lengths (pad_id == 0 never appears in real
        # content), so right-padded rows generate exactly as they would
        # unpadded; an all-pad row still reads one position
        lengths = np.maximum((tokens != 0).sum(axis=1), 1)
        logits, cache = self.model.prefill(
            tok, cache, lengths=torch.from_numpy(lengths).to(dev))
        cur = logits.argmax(dim=-1)[:, None]     # greedy: first max on ties
        _sync(dev)
        ttft = time.perf_counter() - t0
        toks = [cur]
        t1 = time.perf_counter()
        for _ in range(max_new - 1):
            logits, cache = self.model.decode_step(cur, cache)
            cur = logits.argmax(dim=-1)[:, None]
            toks.append(cur)
        ids = torch.cat(toks, dim=1)[:n_real].cpu().numpy()   # [n_real, max_new]
        tpot = (time.perf_counter() - t1) / max(max_new - 1, 1)
        # lock-step semantics: every real request in the batch saw its first
        # token after the shared prefill and decoded at the shared cadence
        for _ in range(n_real):
            self.stats.record(ttft, tpot, max_new)
        return [render_tokens(row) for row in ids]


_FACT = re.compile(r"the (\w+) of ([\w\-]+) is ([\w\-]+)")
_Q = re.compile(r"what is the (\w+) of ([\w\-]+)")


@register("llm", "extractive")
class ExtractiveLLM(BaseLLM):
    """Deterministic reader: extracts `the <attr> of <subj> is <val>` facts
    from the retrieved context.  Highest-version chunk wins (freshness)."""

    def generate(self, prompts: Sequence[str],
                 contexts: Sequence[Sequence[Chunk]]) -> List[str]:
        out = []
        for q, ctx in zip(prompts, contexts):
            m = _Q.search(q.lower())
            answer = ""
            if m:
                attr, subj = m.group(1), m.group(2)
                best_ver = -1
                for c in ctx:
                    for fm in _FACT.finditer(c.text.lower()):
                        if fm.group(1) == attr and fm.group(2) == subj \
                                and c.version >= best_ver:
                            best_ver = c.version
                            answer = fm.group(3)
            out.append(answer)
        return out


@register("llm", "model")
def _model_llm(arch: str = "", smoke: bool = True, max_prompt: int = 256,
               max_new: int = 16, batch_size: int = 8, seed: int = 0,
               cfg: Optional[ModelConfig] = None, device=None) -> ModelLLM:
    """Spec-friendly ModelLLM factory: resolves the architecture id to its
    (smoke or published) ModelConfig unless one is passed directly."""
    if cfg is None:
        if not arch:
            raise ValueError("llm 'model' needs an 'arch' option or a cfg")
        from repro_torch import configs as arch_configs
        cfg = (arch_configs.get_smoke(arch) if smoke
               else arch_configs.get_config(arch))
    return ModelLLM(cfg, max_prompt=max_prompt, max_new=max_new,
                    batch_size=batch_size, seed=seed, device=device)
