"""Partition rules: parameter, optimizer, cache and batch specs. The port
of ``repro.distributed.partition``.

Megatron-style TP for the transformer families by name rules, a shape
heuristic for the recurrent families, ZeRO-1 sharding of the optimizer
moments over the data axes, and batch and cache specs for serving.

Name rules (first match wins, checked against the reference's tree path
of the leaf, ``['layers']['attn']['wq']``):
  embed        -> vocab dim (0) over "model"         (vocab-parallel table)
  lm_head      -> vocab dim (-1) over "model"
  router       -> expert dim (-1) over "model"
  moe/w_*      -> expert dim over "model" (EP)
  wq|wk|wv     -> output dim (-1) over "model"       (column parallel)
  w_up|w_gate  -> output dim (-1) over "model"
  wo|w_down    -> input dim (-2) over "model"        (row parallel)
  norm|bias|dt -> replicated
Fallback: shard the larger of the trailing two dims divisible by the model
axis; replicate otherwise.

The port's parameters are per layer (``layers.<i>.attn.wq``, weights
``[in, out]``) where the reference stacks ``[L, ...]`` leaves (``[G, M,
...]`` for xLSTM's mLSTM blocks, ``[G, E, ...]`` for Zamba2's Mamba2
layers). Each port leaf's spec is the reference's spec of the stacked
leaf with the leading stack dims dropped: the rules run on the stacked
shape (``stacked_layout``), so a fallback or a ZeRO choice reads the same
dims as the reference's. A spec is a tuple with one entry a dim (``None``,
a mesh dim's name, or a tuple of names); ``()`` is replicated, as the
reference's ``P()``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np

from repro_torch.distributed.sharding import Spec, mesh_shape, placements
from repro_torch.models.config import ModelConfig


def dp_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in dp_axes(mesh)] or [1]))


def model_size(mesh) -> int:
    return int(mesh_shape(mesh).get("model", 1))


def _axis_entry(axes):
    """A spec entry for one dim: a str for one axis, a tuple for several."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _spec_with(ndim: int, assignments: Dict[int, Any]) -> Spec:
    out = [None] * ndim
    for dim, ax in assignments.items():
        out[dim % ndim] = _axis_entry(ax)
    return tuple(out)


_REPLICATED = re.compile(r"norm|bias|\bdt\b|'dt'|logA|conv|pos_emb")


def leaf_param_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The reference's spec of one (stacked) leaf at tree path ``path``."""
    m = model_size(mesh)
    nd = len(shape)
    if nd <= 1 or m <= 1 or _REPLICATED.search(path):
        return ()
    # sLSTM blocks are tiny but their recurrence runs once per time step:
    # sharding their weights would turn each step into a collective.
    if "slstm" in path:
        return ()

    def ok(dim):        # dim shardable over the model axis?
        return shape[dim % nd] % m == 0

    if "embed" in path and ok(0):
        return _spec_with(nd, {0: "model"})
    if "lm_head" in path and ok(-1):
        return _spec_with(nd, {-1: "model"})
    if "router" in path and ok(-1):
        return _spec_with(nd, {-1: "model"})
    if "moe" in path and nd >= 3:
        e_dim = nd - 3          # [*stack, E, d, f]
        if shape[e_dim] % m == 0:
            return _spec_with(nd, {e_dim: "model"})
    if re.search(r"w[qkv]\b|'w[qkv]'|w_up|w_gate", path) and ok(-1):
        return _spec_with(nd, {-1: "model"})
    if re.search(r"\bwo\b|'wo'|w_down", path) and ok(-2):
        return _spec_with(nd, {-2: "model"})
    # fallback: the larger trailing dim divisible by the model axis
    cands = [d for d in (nd - 1, nd - 2) if shape[d] % m == 0 and shape[d] >= m]
    if cands:
        best = max(cands, key=lambda d: shape[d])
        return _spec_with(nd, {best: "model"})
    return ()


def zero_spec(pspec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO-1: also shard the largest unsharded dim of an optimizer moment
    over the data axes."""
    d = dp_axes(mesh)
    n = dp_size(mesh)
    if n <= 1 or len(shape) < 1:
        return pspec
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    cands = [i for i in range(len(shape))
             if entries[i] is None and shape[i] % n == 0 and shape[i] >= n]
    if not cands:
        return pspec
    best = max(cands, key=lambda i: shape[i])
    entries[best] = _axis_entry(d)
    return tuple(entries)


# -- the port's per-layer leaves against the reference's stacked ones -------


def stacked_layout(shapes: Mapping[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """``{port name: (reference tree path, stack dims)}`` for a family's
    parameter names (``layers.<i>.attn.wq`` -> ``['layers']['attn']['wq']``
    under ``[L]``). A group of indexed blocks stacks as ``[n]``; xLSTM's
    mLSTM blocks as ``[G, M]`` (G the sLSTM blocks) and Zamba2's Mamba2
    layers as ``[G, E]`` (E ``cfg.shared_attn_every``), as the reference
    stacks them."""
    counts: Dict[str, int] = {}
    for name in shapes:
        parts = name.split(".")
        if len(parts) > 1 and parts[1].isdigit():
            counts[parts[0]] = max(counts.get(parts[0], 0), int(parts[1]) + 1)
    stacks = {g: (n,) for g, n in counts.items()}
    if cfg.family == "ssm" and "mlstm" in counts:
        g = counts["slstm"]
        stacks["mlstm"] = (g, counts["mlstm"] // g)
    if cfg.family == "hybrid" and "mamba" in counts:
        e = cfg.shared_attn_every
        stacks["mamba"] = (counts["mamba"] // e, e)
    out = {}
    for name in shapes:
        parts = name.split(".")
        stack: Tuple[int, ...] = ()
        if len(parts) > 1 and parts[1].isdigit():
            stack = stacks[parts[0]]
            parts = [parts[0]] + parts[2:]
        out[name] = ("".join(f"['{p}']" for p in parts), stack)
    return out


def _per_leaf(shapes: Mapping[str, Any], cfg: ModelConfig, fn) -> Dict[str,
                                                                       Spec]:
    """``fn(path, stacked shape)`` for every leaf, the stack dims' entries
    dropped (a replicated ``()`` stays ``()``)."""
    out = {}
    for name, (path, stack) in stacked_layout(shapes, cfg).items():
        spec = fn(path, (*stack, *tuple(shapes[name].shape)))
        out[name] = tuple(spec)[len(stack):] if spec else ()
    return out


def param_specs(shapes: Mapping[str, Any], mesh, cfg: ModelConfig
                ) -> Dict[str, Spec]:
    """``{name: spec}`` for a family's parameters (anything with a
    ``shape`` by name: the model's ``named_parameters``, meta tensors)."""
    return _per_leaf(shapes, cfg,
                     lambda path, shape: leaf_param_spec(path, shape, mesh))


def _moment_specs(shapes, mesh, cfg) -> Dict[str, Spec]:
    return _per_leaf(shapes, cfg, lambda path, shape: zero_spec(
        leaf_param_spec(path, shape, mesh), shape, mesh))


def opt_state_specs(shapes: Mapping[str, Any], mesh, cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """AdamW's ``mu`` and ``nu`` by ``zero_spec`` of each parameter's spec;
    the host ``step`` replicated."""
    moments = _moment_specs(shapes, mesh, cfg)
    return {"mu": moments, "nu": dict(moments), "step": ()}


def train_state_specs(state_shapes: Mapping[str, Any], mesh,
                      cfg: ModelConfig) -> Dict[str, Any]:
    """Specs of a train state (``params`` and, with compression, ``err``,
    each ``{name: shape-like}``): the parameters by ``param_specs``, the
    moments and the compression residual by ``zero_spec``, as the
    reference places them."""
    params = state_shapes["params"]
    out = {"params": param_specs(params, mesh, cfg),
           "opt": opt_state_specs(params, mesh, cfg)}
    if "err" in state_shapes:
        out["err"] = _moment_specs(params, mesh, cfg)
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def batch_specs(batch_shapes, mesh, global_batch: int):
    """Shard the batch dim over (pod, data); everything else replicated."""
    d = dp_axes(mesh)
    n = dp_size(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] == global_batch and n > 1 \
                and shape[0] % n == 0:
            return _spec_with(len(shape), {0: d})
        # micro-batched train batches: [accum, B/accum, ...]
        if len(shape) >= 2 and shape[1] % n == 0 and n > 1 \
                and shape[1] * (shape[0] or 1) == global_batch:
            return _spec_with(len(shape), {1: d})
        return (None,) * len(shape)

    return _tree_map(one, batch_shapes)


def cache_specs(cache_shapes, mesh, batch: int, max_len: int):
    """Serving cache: the batch dim over (pod, data); the longest other
    dim (typically the KV sequence) over "model"."""
    d = dp_axes(mesh)
    ndp = dp_size(mesh)
    m = model_size(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        entries: Dict[int, Any] = {}
        bdims = [i for i, s in enumerate(shape) if s == batch]
        if bdims and ndp > 1 and batch % ndp == 0:
            entries[bdims[0]] = d
        if m > 1:
            cands = [i for i, s in enumerate(shape)
                     if i not in entries and s % m == 0 and s >= m
                     and i not in bdims]
            if cands:
                # ties go to the trailing dim: for recurrent states
                # [.., d_k, d_v] sharding d_v keeps the q·C contraction
                # (over d_k) local
                entries[max(cands, key=lambda i: (shape[i], i))] = "model"
        return _spec_with(nd, entries)

    return _tree_map(one, cache_shapes)


def zeros_placed(shape, dtype, device, mesh, spec):
    """A zero DTensor of global ``shape`` placed by ``spec``, each rank's
    shard allocated on ``device`` alone (``meta`` allocates nothing)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    pl = placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)
    full = torch.empty(tuple(shape), dtype=dtype, device="meta")
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, pl, run_check=False, shape=full.shape,
                              stride=full.stride())


def distribute(tree, specs, mesh):
    """Every tensor of ``tree`` as a DTensor placed by the spec at the same
    place in ``specs`` (the counterpart of the reference's ``as_named``
    shardings applied to arrays). Every rank holds the same values (drawn
    from one seed, or read from one file): each keeps its own shard of
    its copy, with no communication."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, mesh)
                          for v, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, placements(specs, mesh),
                             src_data_rank=None)
