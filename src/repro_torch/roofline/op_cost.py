"""FLOPs and device bytes of a step function, counted on ``meta`` tensors:
the port's counterpart of ``repro.roofline.hlo_cost`` (which re-derives
them from XLA's post-optimisation HLO text; torch makes no such text).

The step runs once on ``meta`` tensors (shapes only: no card, no
allocation) under two dispatch modes:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
  convolutions: 2 * |result| * |contracted dims|; elementwise operations
  are not counted, as ``hlo_cost`` counts dots only);
* bytes: ``ByteCounter``, a ``TorchDispatchMode`` that charges every
  dispatched operation the bytes of its tensor operands and results (each
  distinct element once: a broadcast operand counts its stored elements),
  skipping views (results that alias an input) and uninitialised
  allocations, as ``hlo_cost`` charges each top-level instruction its
  operands and result. Eager torch runs one kernel an operation, so this
  is the traffic of an unfused step;
* ``sq_bytes``: the part of those bytes in tensors with two sequence-like
  dims (the ``[S, S]`` logits and decay-matrix class), kept apart as
  ``hlo_cost`` keeps them (``_sq_tensor_bytes``): a dim is sequence-like
  if it equals ``seq_len``, or divides it with quotient <= 64 while not
  being one of the config's feature widths.

The port's attention kernels are not ATen operations: on ``meta`` the
model's attention (``kernels.ops.flash_attention``) dispatches to the
library operations ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_bwd`` (``kernels.flash_attention``), whose
FLOP formulas are registered here: ``4 * B * H * dh`` times the visible
(query, key) pairs for the forward and 2.5x that for the backward; their
bytes are their operands and results (q, k, v, o and, under autograd, the
lse; and q, k, v, o, dO, lse, dq, dk, dv), as the kernels keep the
``[S, S]`` tiles on chip.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

import repro_torch.kernels.flash_attention  # noqa: F401 (its operations)
from repro_torch.models.config import ModelConfig, ShapeConfig

def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that attention computes: key ``j``
    visible to query ``i`` iff ``j <= i`` when causal and ``j > i -
    window`` when ``window > 0``."""
    w = window if 0 < window < S else S
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    return S * S - (S - w) * (S - w + 1) // 2


def attention_flops(q_shape, causal: bool, window: int) -> int:
    """The forward's operations: ``4 * B * H * dh`` a visible pair (q kᵀ
    and P v, a multiply and an add each)."""
    B, H, S, dh = q_shape
    return 4 * B * H * dh * visible_pairs(S, causal, window)


BWD_FLOP_RATIO = 2.5   # dV, dP, dQ, dK (and S recomputed): 2.5x the forward


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _fwd_flops(q_shape, k_shape, v_shape, causal, window, with_lse,
               softcap=0.0, *args, out_shape=None, **kwargs) -> int:
    # the same with or without a soft cap: its tanh is elementwise work
    return attention_flops(q_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, dout_shape, lse_shape,
               causal, window, softcap=0.0, *args, out_shape=None,
               **kwargs) -> int:
    return int(BWD_FLOP_RATIO * attention_flops(q_shape, causal, window))


# -- counting ----------------------------------------------------------------

_EMPTY = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided"))
# views whose schema does not mark the result as an alias
_UNMARKED_VIEWS = frozenset(("_unsafe_view",))


def stored_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a broadcast dim, of
    stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_view(func) -> bool:
    """A result aliases an input without writing it (a view)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class ByteCounter(TorchDispatchMode):
    """Device bytes of every dispatched operation: its tensor operands and
    results, each tensor once an operation; views and uninitialised
    allocations are free. ``sq_bytes`` holds the part in tensors with two
    sequence-like dims."""

    def __init__(self, seq_len: int = 0,
                 feature_dims: frozenset = frozenset()):
        super().__init__()
        self.seq_len = seq_len
        self.feature_dims = frozenset(feature_dims)
        self.bytes = 0.0
        self.sq_bytes = 0.0
        self.per_op: Dict[str, float] = {}

    def _seq_like(self, d: int) -> bool:
        S = self.seq_len
        if S <= 0:
            return False
        if d == S:
            return True
        return (d not in self.feature_dims and d >= 16 and S % d == 0
                and S // d <= 64)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if _is_view(func) or name in _EMPTY or name in _UNMARKED_VIEWS:
            return out
        seen, total, sq = set(), 0, 0
        for t in (*_tensors(args), *_tensors(kwargs or {}), *_tensors(out)):
            if id(t) in seen:
                continue
            seen.add(id(t))
            b = stored_bytes(t)
            total += b
            if sum(1 for d in t.shape if self._seq_like(d)) >= 2:
                sq += b
        self.bytes += total
        self.sq_bytes += sq
        self.per_op[name] = self.per_op.get(name, 0.0) + total
        return out


# -- a sharded step: each rank's local operations and its collectives -------

# the functional collectives DTensor issues -> the reference's kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def link_factor(kind: str, n: int) -> float:
    """A rank's link bytes as a multiple of a collective's result bytes,
    for ring algorithms (the reference's ``_link_factor``): all-gather
    (n-1)/n of the gathered result; all-reduce 2(n-1)/n; reduce-scatter
    n-1 times the scattered shard; all-to-all (n-1)/n; a permute or a
    broadcast the whole result once."""
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "all-reduce":
        return 2 * (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "all-to-all":
        return (n - 1) / n
    return 1.0


class ShardedCounter(ByteCounter):
    """``ByteCounter`` of one rank's work in a step on DTensors: it steps
    aside for every DTensor-level operation (returns ``NotImplemented``,
    so DTensor runs it) and counts the local operations that DTensor
    dispatches, with their FLOPs by ``torch.utils.flop_counter``'s
    formulas, and the link bytes of each functional collective (its
    result's bytes times ``link_factor`` for its group's size). DTensor's
    shape propagation (the operation on ``FakeTensor`` global shapes) is
    not counted."""

    def __init__(self, seq_len: int = 0,
                 feature_dims: frozenset = frozenset()):
        super().__init__(seq_len, feature_dims)
        self.flops = 0.0
        self.per_op_flops: Dict[str, float] = {}
        self.collectives: Dict[str, float] = dict.fromkeys(
            ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"), 0.0)
        self.n_collectives: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(isinstance(t, FakeTensor) for t in _tensors(args)):
            # DTensor's shape propagation on the global shapes: no work
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            n = float(flop_registry[packet](*args, **(kwargs or {}),
                                            out_val=out))
            self.flops += n
            self.per_op_flops[name] = self.per_op_flops.get(name, 0.0) + n
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None and "c10d_functional" in str(func.namespace):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group

            group = _resolve_process_group(args[-1] if isinstance(
                args[-1], str) else kwargs["group_name"])
            b = sum(stored_bytes(t) for t in _tensors(out))
            self.collectives[kind] += b * link_factor(kind, group.size())
            self.n_collectives[kind] = self.n_collectives.get(kind, 0) + 1
        return out


@dataclass
class OpCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    sq_bytes: float = 0.0        # traffic of [S, S]-shaped tensors
    per_op_flops: Dict[str, float] = field(default_factory=dict)
    per_op_bytes: Dict[str, float] = field(default_factory=dict)
    # a sharded step's link bytes per rank by kind, and the counts of its
    # collectives (None for a one-device step)
    collectives: Optional[Dict[str, float]] = None
    n_collectives: Optional[Dict[str, int]] = None

    @property
    def link_bytes(self) -> float:
        return sum((self.collectives or {}).values())


def analyze(step: Callable[[], object], seq_len: int = 0,
            feature_dims: frozenset = frozenset(),
            sharded: bool = False) -> OpCost:
    """The cost of one call of ``step`` (which builds or takes its tensors
    on ``meta``). ``sharded``: ``step`` runs on DTensors, and the cost is
    one rank's (its local operations and its collectives)."""
    if sharded:
        counter = ShardedCounter(seq_len, feature_dims)
        with counter:
            step()
        return OpCost(flops=counter.flops, hbm_bytes=counter.bytes,
                      sq_bytes=counter.sq_bytes,
                      per_op_flops=dict(counter.per_op_flops),
                      per_op_bytes=dict(counter.per_op),
                      collectives=dict(counter.collectives),
                      n_collectives=dict(counter.n_collectives))
    counter = ByteCounter(seq_len, feature_dims)
    flops = FlopCounterMode(display=False)
    with flops, counter:
        step()
    per_op = {str(op).split(".")[-1]: float(n) for op, n in
              flops.get_flop_counts().get("Global", {}).items()}
    return OpCost(flops=float(flops.get_total_flops()),
                  hbm_bytes=counter.bytes, sq_bytes=counter.sq_bytes,
                  per_op_flops=per_op, per_op_bytes=dict(counter.per_op))


# -- one model step --------------------------------------------------------


def meta_batch(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, object]:
    """A step's inputs on ``meta``: token ids (a vlm's embeddings), labels,
    and Whisper's frames."""
    out = {"labels": torch.empty((batch, seq), dtype=torch.long,
                                 device="meta")}
    if cfg.uses_tokens:
        out["tokens"] = torch.empty((batch, seq), dtype=torch.long,
                                    device="meta")
    else:
        out["embeds"] = torch.empty((batch, seq, cfg.d_model),
                                    device="meta")
    if cfg.family == "audio":
        out["frames"] = torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                                    device="meta")
    return out


def step_cost(cfg: ModelConfig, shape: ShapeConfig,
              train_config=None) -> OpCost:
    """The cost of one step of ``shape.kind`` for ``cfg`` at its batch and
    length: ``train`` is ``train.train_step``'s step (loss, backward with
    ``cfg.remat``'s recomputation, AdamW); ``prefill`` the full-sequence
    forward; ``decode`` one token against a cache of ``seq_len``."""
    from repro_torch.models import api
    from repro_torch.roofline.analysis import feature_dims

    B, S = shape.global_batch, shape.seq_len
    model = api.build(cfg, device="meta")
    feats = feature_dims(cfg)
    if shape.kind == "train":
        from repro_torch.train import train_step as ts

        tcfg = train_config or ts.TrainConfig()
        state = ts.train_state(model, tcfg)
        step = ts.make_train_step(cfg, tcfg)
        batch = meta_batch(cfg, B, S)
        return analyze(lambda: step(state, batch), S, feats)
    if shape.kind == "prefill":
        batch = meta_batch(cfg, B, S)

        def run():
            with torch.no_grad():
                return api.get_model(cfg).logits(model, batch)

        return analyze(run, S, feats)
    if shape.kind == "decode":
        cache = model.init_cache(B, S)
        tokens = meta_batch(cfg, B, 1)

        def run():
            with torch.no_grad():
                return model.decode_step(
                    tokens["tokens"] if cfg.uses_tokens else tokens["embeds"],
                    cache)

        return analyze(run, S, feats)
    raise ValueError(shape.kind)
