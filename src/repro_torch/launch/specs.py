"""One (architecture x input shape) cell of the dry-run: the step, its
inputs on ``meta``, and their specs. The port of ``repro.launch.specs``.

``build_cell(cfg, shape, mesh)`` returns what the dry-run needs to run one
cell's step once on a mesh without allocating anything: the step
callable, its example inputs (``meta`` tensors: shapes only) and their
specs. Shape semantics follow the reference:

  train_4k     -> train_step(state, batch)            (fwd + bwd + AdamW)
  prefill_32k  -> prefill(inputs, cache)              (prompt pass)
  decode_32k   -> decode_step: one new token against a KV/state cache of
                  seq_len
  long_500k    -> the same decode step at 524288 (sub-quadratic archs only)

``lower_cell`` places the inputs as ``meta`` DTensors by their specs and
runs the step once under the mesh's sharding rules, counting one rank's
local operations and its collectives (``roofline.op_cost``): the port's
counterpart of the reference's AOT ``lower``. Every family lowers: the
dense, MoE (expert-parallel) and vlm transformers, Whisper (its frames
beside the tokens, its self and cross caches), xLSTM and Zamba2 (their
recurrent states in the cache).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed import partition as pt
from repro_torch.models import api
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                          shard_model, train_state)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def model_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """The input tree of a forward or loss of one family: token ids (a
    vlm's stub-frontend embeddings), and Whisper's frames."""
    out: Dict[str, Any] = {}
    if cfg.family == "vlm":
        out["embeds"] = _meta((batch, seq, cfg.d_model), _DTYPES[cfg.dtype])
    else:
        out["tokens"] = _meta((batch, seq), torch.int32)
    if cfg.family == "audio":
        out["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model),
                              _DTYPES[cfg.dtype])
    return out


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int,
                       accum: int = 1) -> Dict:
    shapes = model_batch_shapes(cfg, batch, seq)
    shapes["labels"] = _meta((batch, seq), torch.int32)
    if accum > 1:
        shapes = {k: _meta((accum, s.shape[0] // accum, *s.shape[1:]),
                           s.dtype) for k, s in shapes.items()}
    return shapes


@dataclass
class Cell:
    """One dry-run unit: a callable of its placed inputs, the inputs (meta
    tensors, or a state already placed on the mesh) and their specs."""
    fn: Callable
    inputs: Tuple          # positional, meta tensors
    in_specs: Tuple        # spec trees matching ``inputs``
    kind: str
    rules: dict = None     # logical-rule overrides (family-aware)
    state: Any = None      # the placed train state or model


def family_rules(cfg: ModelConfig) -> dict:
    """Per-family logical-rule overrides: none (the reference found the
    sequence-parallel residual the better layout for the recurrent forms
    too)."""
    return {}


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               train_cfg: TrainConfig = None) -> Cell:
    """The cell of ``cfg`` at ``shape`` on ``mesh``; its model and state
    live on ``meta`` and are placed on the mesh here (nothing is
    allocated)."""
    B, S = shape.global_batch, shape.seq_len
    model = api.build(cfg, device="meta")
    if shape.kind == "train":
        tcfg = train_cfg or TrainConfig()
        state = train_state(model, tcfg, mesh)
        batch = train_batch_shapes(cfg, B, S, tcfg.accum_steps)
        step = make_train_step(cfg, tcfg)
        return Cell(fn=lambda b: step(state, b), inputs=(batch,),
                    in_specs=(pt.batch_specs(batch, mesh, B),),
                    kind="train", rules=family_rules(cfg), state=state)

    model.requires_grad_(False)
    shard_model(model, mesh, pt.param_specs(dict(model.named_parameters()),
                                            mesh, cfg))
    seq = S if shape.kind == "prefill" else 1
    batch = model_batch_shapes(cfg, B, seq)
    cache = api.init_cache_shape(cfg, B, S)
    bspecs = pt.batch_specs(batch, mesh, B)
    cspecs = pt.cache_specs(cache, mesh, B, S)
    key = "tokens" if cfg.uses_tokens else "embeds"

    def run(b, c):
        c = dict(c, pos=0 if shape.kind == "prefill" else S - 1)
        with torch.no_grad():
            if shape.kind == "prefill":
                extra = (b["frames"],) if cfg.family == "audio" else ()
                return model.prefill(b[key], c, *extra)
            return model.decode_step(b[key], c)

    return Cell(fn=run, inputs=(batch, cache), in_specs=(bspecs, cspecs),
                kind=shape.kind, rules=family_rules(cfg), state=model)


def place(inputs: Tuple, in_specs: Tuple, mesh) -> Tuple:
    """The meta inputs as meta DTensors by their specs (a 0-d host scalar
    stays as it is)."""
    return tuple(pt.distribute(t, s, mesh)
                 for t, s in zip(inputs, in_specs))


def lower_cell(cell: Cell, mesh, seq_len: int = 0,
               feature_dims: frozenset = frozenset()):
    """Run the cell's step once on ``meta`` DTensors on ``mesh`` (no
    buffer is allocated) under the sharding rules. Returns ``(cost, args,
    outputs)``: one rank's ``roofline.op_cost.OpCost`` (its local FLOPs
    and bytes and its collectives' link bytes by kind), the placed inputs
    and the step's outputs."""
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.roofline import op_cost

    args = place(cell.inputs, cell.in_specs, mesh)
    out = {}

    def step():
        out["step"] = cell.fn(*args)

    with sharding_rules(mesh, cell.rules):
        cost = op_cost.analyze(step, seq_len, feature_dims, sharded=True)
    return cost, args, out["step"]
