"""Token-level continuous-batching generation engine (the vLLM analogue):
the port of ``repro.serving.genengine``.

``ModelLLM`` schedules at *request-batch* granularity: a batch prefills
together, decodes in lock-step for ``max_new`` steps, and only then admits
the next batch. ``GenEngine`` schedules at *token* granularity over a fixed
pool of KV-cache slots:

* **slot pool**: the KV cache is allocated once as ``[L, slots, max_len]``;
  each slot holds one in-flight sequence at its own decode position (the
  ``[slots]`` ``pos`` tensor of ``models.layers.cached_attention_step``).
* **chunked prefill**: prompts are split into ``chunk_tokens``-sized chunks
  processed between decode steps under a ``prefill_chunks_per_step``
  budget, so admitting a long prompt delays in-flight requests' next token
  by at most that budget, not one full prompt.
* **continuous admission**: every engine step moves newly arrived requests
  into free slots (``fcfs`` or shortest-prompt-first ``sjf``) and retires
  finished sequences per slot; the decode batch never drains to admit.
* **per-request metrics**: TTFT from a request's submitted arrival time to
  its first token, TPOT from its own decode cadence; samples land in a
  thread-safe ``GenStats`` (replica engines share one), and the scheduling
  counts (steps, prefill chunks, decode steps and the slots each decoded)
  in a shared ``EngineCounters``.

Greedy decode attends only within a sequence's own cache row, so the engine
gives the lock-step ``ModelLLM``'s tokens (same weights, same prompts):
scheduling freedom, never semantics. A retiring sequence's K/V is not
zeroed: every mask bounds reads at the row's current position, writes go
strictly forward from 0 (prefill chunks) then from the prompt's length
(decode), and each position is overwritten before it first becomes
readable, so stale K/V of a previous occupant or of a right-padded final
chunk is never attended.

The model runs eagerly (the reference's jit caches have no counterpart);
``_EngineCore`` holds the shared ``Transformer`` and tokenizer. One
``GenEngine`` is owned by one worker thread (the elastic executor clones a
warm engine per generation replica), so the engine holds no locks; the
shared ``GenStats`` and ``EngineCounters`` guard their own fields.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import require_same_device, resolve_device
from repro_torch.core.generator import (GenStats, ModelLLM, build_prompt,
                                        render_tokens)
from repro_torch.core.interfaces import BaseLLM, Chunk
from repro_torch.core.registry import register
from repro_torch.core.tokenizer import HashTokenizer
from repro_torch.models import api
from repro_torch.models.config import ModelConfig

ADMISSION_POLICIES = ("fcfs", "sjf")
# families whose decode takes per-row positions (the reference's
# core.generator.PER_ROW_POS_FAMILIES); the engine takes the token-input
# ones (not the vlm backbone), as the reference's does
PER_ROW_POS_FAMILIES = ("dense", "moe", "vlm")


@dataclass
class GenRequest:
    """One generation request's lifecycle through the slot pool."""

    rid: int
    tokens: np.ndarray              # [P] int32, unpadded true prompt
    max_new: int
    t_arrive: float
    prompt_len: int = 0
    filled: int = 0                 # prompt tokens prefilled so far
    slot: int = -1
    out: List[int] = field(default_factory=list)
    t_first: float = 0.0            # wall time of the first token
    t_done: float = 0.0
    state: str = "queued"           # queued | prefill | decode | done

    def __post_init__(self):
        self.prompt_len = len(self.tokens)

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_arrive

    @property
    def tpot_s(self) -> float:
        return ((self.t_done - self.t_first) / max(len(self.out) - 1, 1)
                if len(self.out) > 1 else 0.0)


@dataclass
class EngineCounters:
    """Scheduling counts of an engine and its clones, safe under
    concurrent recording (replica engines share one)."""

    steps: int = 0                  # guarded-by: _lock
    prefill_chunks: int = 0         # guarded-by: _lock
    decode_steps: int = 0           # guarded-by: _lock
    decode_rows: int = 0            # guarded-by: _lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    _FIELDS = ("steps", "prefill_chunks", "decode_steps", "decode_rows")

    def add(self, **counts: int) -> None:
        with self._lock:
            for name, n in counts.items():
                setattr(self, name, getattr(self, name) + int(n))

    def copy(self) -> "EngineCounters":
        with self._lock:
            return EngineCounters(**{f: getattr(self, f)
                                     for f in self._FIELDS})

    def reset(self, to: Optional["EngineCounters"] = None) -> None:
        """Zero every count, or set them to ``to``'s."""
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0 if to is None else getattr(to, f))

    def summary(self) -> Dict[str, float]:
        """The counts, and the mean of the slots each decode step ran."""
        with self._lock:
            out = {f: float(getattr(self, f)) for f in self._FIELDS}
        out["mean_active_slots"] = (out["decode_rows"] / out["decode_steps"]
                                    if out["decode_steps"] else 0.0)
        return out


class _EngineCore:
    """What replica engines share: the model and the tokenizer. Cloning an
    engine reuses the core, so a warm-pool replica costs one cache
    allocation and no second weight copy."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, model=None,
                 device=None):
        assert cfg.family in PER_ROW_POS_FAMILIES and cfg.uses_tokens, (
            f"GenEngine needs a token-input transformer family "
            f"(one of {PER_ROW_POS_FAMILIES} using tokens), got "
            f"{cfg.family!r}")
        assert cfg.rope_type in ("rope", "none"), (
            f"chunked prefill supports rope/none positions, "
            f"got {cfg.rope_type!r}")
        self.cfg = cfg
        if model is None:
            self.device = resolve_device(device)
            model = api.get_model(cfg).init(cfg, seed, self.device)
        else:
            self.device = (model.device if device is None
                           else resolve_device(device))
        require_same_device("GenEngine", model, self.device)
        self.model = model
        self.tok = HashTokenizer(cfg.vocab_size)

    def prefill_slot(self, tokens: torch.Tensor, cache: Dict, slot: int,
                     offset: int) -> torch.Tensor:
        """Prefill one chunk of one slot inside the pooled cache, on a view
        of the slot's row (written in place); returns the chunk's logits
        ``[1, C, V]``."""
        row = {"k": cache["k"][:, slot:slot + 1],
               "v": cache["v"][:, slot:slot + 1]}
        logits, _ = self.model.prefill_chunk(tokens, row, offset)
        return logits


class GenEngine:
    """Fixed-slot continuous-batching engine over one ``_EngineCore``.

    Drive it as a service (``submit`` + ``step`` in a loop) or in batch
    (``run``), which steps to completion and returns answers in submission
    order. ``device=None`` is the card.
    """

    def __init__(self, cfg: Optional[ModelConfig] = None, slots: int = 4,
                 chunk_tokens: int = 32, prefill_chunks_per_step: int = 1,
                 admission: str = "fcfs", max_prompt: int = 256,
                 max_new: int = 16, seed: int = 0,
                 stats: Optional[GenStats] = None,
                 core: Optional[_EngineCore] = None, device=None,
                 counters: Optional[EngineCounters] = None):
        assert slots >= 1 and chunk_tokens >= 1 and max_new >= 1
        assert prefill_chunks_per_step >= 1
        assert admission in ADMISSION_POLICIES, admission
        assert (cfg is not None) or (core is not None), "need cfg or core"
        self.core = (core if core is not None
                     else _EngineCore(cfg, seed=seed, device=device))
        self.cfg = self.core.cfg
        self.device = self.core.device
        self.slots = slots
        self.chunk_tokens = chunk_tokens
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self.admission = admission
        self.max_prompt = max_prompt
        self.max_new = max_new
        self._max_new_cap = max_new
        self.stats = stats if stats is not None else GenStats()
        self.counters = counters if counters is not None else EngineCounters()
        self.tok = self.core.tok
        # the prompt region is rounded up to the chunk grid so a right-padded
        # final chunk always fits before the decode region
        n_chunks = -(-max_prompt // chunk_tokens)
        self.max_len = n_chunks * chunk_tokens + max_new
        self.cache = self.core.model.init_cache(slots, self.max_len)
        # per-slot decode positions, uploaded as the [slots] pos tensor
        self._pos = np.zeros(slots, dtype=np.int64)
        self._cur = np.zeros(slots, dtype=np.int64)   # last emitted token
        self._slot_req: List[Optional[GenRequest]] = [None] * slots
        self._free: List[int] = list(range(slots))
        self._queue: deque = deque()
        self._rr = 0                 # round-robin cursor over prefill slots
        self._next_rid = 0
        self.records: Dict[int, GenRequest] = {}
        # optional obs.Tracer for token-level instants (prefill chunks,
        # first token, retirement); clones inherit it
        self.tracer = None

    # the reference's per-engine counts (here: of the engine and its clones)
    @property
    def n_steps(self) -> int:
        return self.counters.copy().steps

    @property
    def n_prefill_chunks(self) -> int:
        return self.counters.copy().prefill_chunks

    @property
    def n_decode_steps(self) -> int:
        return self.counters.copy().decode_steps

    # -- replica support ----------------------------------------------------

    def clone(self, stats: Optional[GenStats] = None) -> "GenEngine":
        """A warm replica: shares the core (the weights), the counters and,
        by default, the thread-safe stats; gets its own slot pool, sized
        for the configured ``max_new`` ceiling with the current (possibly
        ladder-degraded) value carried as the runtime knob."""
        twin = GenEngine(core=self.core, slots=self.slots,
                         chunk_tokens=self.chunk_tokens,
                         prefill_chunks_per_step=self.prefill_chunks_per_step,
                         admission=self.admission, max_prompt=self.max_prompt,
                         max_new=self._max_new_cap,
                         stats=stats if stats is not None else self.stats,
                         counters=self.counters)
        twin.set_max_new(self.max_new)
        twin.tracer = self.tracer
        return twin

    def set_max_new(self, n: int) -> int:
        """Autoscale knob: decode length for newly admitted requests,
        clamped to the cache's configured ceiling."""
        self.max_new = max(1, min(int(n), self._max_new_cap))
        return self.max_new

    # -- submission ---------------------------------------------------------

    def encode_prompt(self, text: str) -> np.ndarray:
        ids = self.tok.encode(text, self.max_prompt)
        if not ids:
            ids = [self.tok.pad_id]     # empty prompt still reads position 0
        return np.asarray(ids, dtype=np.int32)

    def submit(self, prompt: str, t_arrive: Optional[float] = None,
               max_new: Optional[int] = None) -> int:
        """Queue one prompt; returns the request id. ``t_arrive`` anchors
        the TTFT measurement (defaults to now)."""
        req = GenRequest(
            rid=self._next_rid, tokens=self.encode_prompt(prompt),
            max_new=max(1, min(int(max_new or self.max_new),
                               self._max_new_cap)),
            t_arrive=time.perf_counter() if t_arrive is None else t_arrive)
        self._next_rid += 1
        self._queue.append(req)
        self.records[req.rid] = req
        return req.rid

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_active(self) -> int:
        return self.slots - len(self._free)

    def busy(self) -> bool:
        return bool(self._queue) or self.n_active > 0

    # -- the engine step ----------------------------------------------------

    def step(self) -> bool:
        """One scheduling iteration: admit, prefill budget, one decode
        step, retire. Returns True if any work was done."""
        self.counters.add(steps=1)
        self._admit()
        did = self._prefill_work()
        did = self._decode_work() or did
        return did

    def _admit(self) -> None:
        while self._free and self._queue:
            if self.admission == "sjf":
                # shortest prompt first; FIFO tie-break
                best = min(range(len(self._queue)),
                           key=lambda i: (self._queue[i].prompt_len, i))
                self._queue.rotate(-best)
                req = self._queue.popleft()
                self._queue.rotate(best)
            else:
                req = self._queue.popleft()
            slot = self._free.pop(0)
            req.slot, req.state, req.filled = slot, "prefill", 0
            self._slot_req[slot] = req
            self._pos[slot] = 0

    def _slots_in(self, state: str) -> List[int]:
        return [s for s in range(self.slots)
                if self._slot_req[s] is not None
                and self._slot_req[s].state == state]

    def _prefill_work(self) -> bool:
        """Spend the per-step prefill budget (``prefill_chunks_per_step``
        chunks), round-robin across slots so concurrent prefills share it.
        Consecutive chunks of one prompt run as one call (the same math:
        chunk attention is position-masked)."""
        budget = self.prefill_chunks_per_step
        did = False
        while budget > 0:
            pending = self._slots_in("prefill")
            if not pending:
                break
            slot = pending[self._rr % len(pending)]
            self._rr += 1
            req = self._slot_req[slot]
            rem = -(-(req.prompt_len - req.filled) // self.chunk_tokens)
            n = min(budget, rem)
            self._prefill_chunks(req, n)
            budget -= n
            did = True
        return did

    @torch.no_grad()
    def _prefill_chunks(self, req: GenRequest, n_chunks: int) -> None:
        C = n_chunks * self.chunk_tokens
        off = req.filled
        chunk = req.tokens[off:off + C]
        n = len(chunk)
        if n < C:                       # right-pad the final chunk; padded
            chunk = np.pad(chunk, (0, C - n))  # K/V is never attended
        logits = self.core.prefill_slot(
            torch.from_numpy(chunk[None]).to(self.device), self.cache,
            req.slot, off)
        self.counters.add(prefill_chunks=n_chunks)
        req.filled = off + n
        tr = self.tracer
        if tr is not None:
            tr.instant("gen.prefill_chunk", cat="gen", tid="gen",
                       rid=req.rid, chunks=n_chunks, filled=req.filled)
        # park the slot's decode position at the next write offset: a
        # ride-along decode write lands exactly where the next real write
        # (chunk or first decode token) will overwrite it
        self._pos[req.slot] = req.filled
        if req.filled >= req.prompt_len:
            # final chunk: the last real token's logits give the first
            # token (argmax takes the first maximum, as jnp.argmax does)
            first = int(logits[0, req.prompt_len - 1 - off].argmax())
            req.out.append(first)
            req.t_first = time.perf_counter()
            if tr is not None:
                tr.instant("gen.first_token", cat="gen", tid="gen",
                           rid=req.rid)
            req.state = "decode"
            self._cur[req.slot] = first
            self._pos[req.slot] = req.prompt_len
            if len(req.out) >= req.max_new:
                self._retire(req)

    @torch.no_grad()
    def _decode_work(self) -> bool:
        """One batched decode step across every slot in decode state.

        Idle and prefilling slots ride along (one fixed-shape batch over
        the pool), parked at their next write offset: their garbage writes
        sit exactly where the next real write will land, so they are
        overwritten before they ever become attendable.
        """
        active = self._slots_in("decode")
        if not active:
            return False
        dev = self.device
        self.cache["pos"] = torch.from_numpy(self._pos.copy()).to(dev)
        tokens = torch.from_numpy(self._cur[:, None].copy()).to(dev)
        logits, self.cache = self.core.model.decode_step(tokens, self.cache)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        self.counters.add(decode_steps=1, decode_rows=len(active))
        for s in active:
            req = self._slot_req[s]
            req.out.append(int(nxt[s]))
            self._cur[s] = int(nxt[s])
            self._pos[s] += 1
            if len(req.out) >= req.max_new:
                req.t_done = now
                self._retire(req)
        return True

    def _retire(self, req: GenRequest) -> None:
        if req.t_done == 0.0:
            req.t_done = time.perf_counter()
        req.state = "done"
        tr = self.tracer
        if tr is not None:
            tr.instant("gen.retire", cat="gen", tid="gen",
                       rid=req.rid, tokens=len(req.out))
        self.stats.record(req.ttft_s, req.tpot_s, len(req.out))
        self._slot_req[req.slot] = None
        self._free.append(req.slot)
        self._free.sort()

    # -- batch drive --------------------------------------------------------

    def run(self, prompts: Sequence[str]) -> List[str]:
        """Submit every prompt now, step to completion, return the decoded
        answer strings in submission order. Batch mode owns its records:
        they are popped after rendering (service-mode callers driving
        ``submit``/``step`` pop ``records[rid]`` themselves)."""
        t0 = time.perf_counter()
        rids = [self.submit(p, t_arrive=t0) for p in prompts]
        while self.busy():
            self.step()
        return [render_tokens(self.records.pop(r).out) for r in rids]


class EngineLLM(BaseLLM):
    """``BaseLLM`` drop-in over ``GenEngine``: the ``model_engine`` registry
    component. ``generate`` batches through the slot pool; serving paths
    that want per-request arrival anchoring drive ``engine`` directly."""

    def __init__(self, cfg: Optional[ModelConfig] = None, slots: int = 4,
                 chunk_tokens: int = 32, prefill_chunks_per_step: int = 1,
                 admission: str = "fcfs", max_prompt: int = 256,
                 max_new: int = 16, seed: int = 0,
                 engine: Optional[GenEngine] = None, device=None):
        self.engine = engine if engine is not None else GenEngine(
            cfg, slots=slots, chunk_tokens=chunk_tokens,
            prefill_chunks_per_step=prefill_chunks_per_step,
            admission=admission, max_prompt=max_prompt, max_new=max_new,
            seed=seed, device=device)
        self.cfg = self.engine.cfg

    @property
    def stats(self) -> GenStats:
        return self.engine.stats

    @property
    def max_new(self) -> int:
        return self.engine.max_new

    def set_max_new(self, n: int) -> int:
        return self.engine.set_max_new(n)

    def clone(self) -> "EngineLLM":
        """Warm-pool replica: its own slot pool; the weights, the stats and
        the counters shared."""
        return EngineLLM(engine=self.engine.clone())

    def generate(self, prompts: Sequence[str],
                 contexts: Sequence[Sequence[Chunk]]) -> List[str]:
        texts = [build_prompt(p, c) for p, c in zip(prompts, contexts)]
        return self.engine.run(texts)


def engine_from_model_llm(llm: ModelLLM, **kw) -> GenEngine:
    """An engine on a lock-step ``ModelLLM``'s model (the same weight
    tensors) and prompt/decode lengths: the like-for-like comparison of the
    equivalence checks."""
    core = _EngineCore(llm.cfg, model=llm.model)
    kw.setdefault("max_prompt", llm.max_prompt)
    kw.setdefault("max_new", llm.max_new)
    return GenEngine(core=core, **kw)


@register("llm", "model_engine")
def _engine_llm(arch: str = "", smoke: bool = True, slots: int = 4,
                chunk_tokens: int = 32, prefill_chunks_per_step: int = 1,
                admission: str = "fcfs", max_prompt: int = 256,
                max_new: int = 16, seed: int = 0,
                cfg: Optional[ModelConfig] = None, device=None) -> EngineLLM:
    """Spec-friendly continuous-batching LLM factory (mirrors ``model``)."""
    if cfg is None:
        if not arch:
            raise ValueError("llm 'model_engine' needs an 'arch' option or "
                             "a cfg")
        from repro_torch import configs as arch_configs
        cfg = (arch_configs.get_smoke(arch) if smoke
               else arch_configs.get_config(arch))
    return EngineLLM(cfg, slots=slots, chunk_tokens=chunk_tokens,
                     prefill_chunks_per_step=prefill_chunks_per_step,
                     admission=admission, max_prompt=max_prompt,
                     max_new=max_new, seed=seed, device=device)
