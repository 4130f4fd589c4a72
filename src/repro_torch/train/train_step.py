"""The train step: loss -> gradients -> (accumulate) -> (compress) -> clip
-> AdamW. The port of ``repro.train.train_step``.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``. The state is a dict: ``model`` (the family's ``nn.Module``,
its parameters trainable), ``params`` (its ``named_parameters``), ``opt``
(AdamW's fp32 ``mu`` and ``nu`` by name and its host ``step``) and, with
gradient compression, ``err`` (the fp32 error-feedback residual by name).
The step updates the parameters and moments in place (the reference
returns new trees) and returns the same dict with the new ``opt``.

Gradients come from ``torch.autograd.grad`` of the family's ``loss_fn``
(``models.api.loss_fn``), in the parameters' dtype. With ``accum_steps >
1`` the batch's leaves carry a leading ``[accum_steps, ...]`` dim and the
micro-batches' gradients are summed in fp32, then averaged, as the
reference's ``lax.scan`` does. ``compress_grads`` passes them through
int8 with error feedback (``_quantize_tree``) before the optimizer: what
a data-parallel all-reduce would carry. Metrics: ``loss``, ``grad_norm``
(before clipping) and ``lr``, as tensors (no host synchronisation).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, fp32_zeros)

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    accum_steps: int = 1               # microbatches per step
    compress_grads: bool = False       # int8 + error feedback
    moe_impl: str = "sort"


def shard_model(model: nn.Module, mesh, specs: Dict) -> None:
    """Replace every parameter of ``model`` by a DTensor placed by
    ``specs`` (``{name: spec}``), each rank keeping its shard of its own
    copy (every rank holds the same values: no communication)."""
    from repro_torch.distributed.partition import distribute

    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        dt = distribute(p.detach(), specs[name], mesh)
        mod.register_parameter(attr, nn.Parameter(dt,
                                                  requires_grad=p.requires_grad))


def train_state(model: nn.Module, tcfg: TrainConfig, mesh=None) -> Dict:
    """The train state around ``model``, whose parameters become
    trainable: zero fp32 moments, step 0 and, with compression, a zero
    fp32 residual. On a mesh of more than one device the state is placed
    as the reference places it (``distributed.partition``): the
    parameters by ``param_specs``, the moments and the residual by
    ``zero_spec`` (ZeRO-1 over ("pod", "data"))."""
    model.requires_grad_(True)
    sharded = mesh is not None and mesh.size() > 1
    if sharded:
        from repro_torch.distributed import partition as pt

        specs = pt.train_state_specs(
            {"params": dict(model.named_parameters())}, mesh, model.cfg)
        shard_model(model, mesh, specs["params"])
    params = dict(model.named_parameters())
    moments, mesh = (specs["opt"]["mu"], mesh) if sharded else (None, None)
    state = {"model": model, "params": params,
             "opt": adamw_init(params, moments, mesh)}
    if tcfg.compress_grads:
        state["err"] = fp32_zeros(params, moments, mesh)
    return state


def init_train_state(seed: int, cfg: ModelConfig, tcfg: TrainConfig,
                     device=None, mesh=None) -> Dict:
    """A model of ``cfg`` with random weights from ``seed`` (the family's
    ``init``) on ``device`` (``None`` is the card), in a train state
    (placed on ``mesh`` when it has more than one device: every rank
    draws the whole model from the same seed and keeps its shards)."""
    return train_state(api.get_model(cfg).init(cfg, seed, device), tcfg,
                       mesh)


def _host(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    from repro_torch.distributed.sharding import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


# -- int8 gradient compression with error feedback ---------------------------


def _quantize_tree(grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
    """g + err -> int8 codes + a scale a leaf; returns (dequantized,
    new_err)."""
    deq, new_err = {}, {}
    for name, g in grads.items():
        g = g.float() + err[name]
        scale = g.abs().max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq[name] = q.float() * scale
        new_err[name] = g - deq[name]
    return deq, new_err


def _to_moments(grads: Tree, moments: Tree) -> Tree:
    """Each DTensor gradient at its moment's placement (a partial sum over
    the data ranks reduce-scattered onto the ZeRO shard); plain tensors as
    they are."""
    from repro_torch.distributed.sharding import is_dtensor

    return {n: (g.redistribute(moments[n].device_mesh, moments[n].placements)
                if is_dtensor(g) else g) for n, g in grads.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()
                    ) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    is a dict of tensors on the model's device (``tokens``, ``labels``; a
    vlm's ``embeds``, Whisper's ``frames``)."""

    def grads_of(model, names, plist, batch):
        loss = api.loss_fn(model, batch, tcfg.moe_impl)
        gs = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for n, p, g in zip(names, plist, gs)}

    def train_step(state: Dict, batch: Dict):
        model, params = state["model"], state["params"]
        names, plist = list(params), list(params.values())
        if tcfg.accum_steps > 1:
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            total = 0.0
            for i in range(tcfg.accum_steps):
                loss, g = grads_of(model, names, plist,
                                   {k: v[i] for k, v in batch.items()})
                for n in names:
                    acc[n].add_(g[n].float())
                total = total + loss
                del g
            grads = {n: a / tcfg.accum_steps for n, a in acc.items()}
            loss = total / tcfg.accum_steps
        else:
            loss, grads = grads_of(model, names, plist, batch)
        new_state = dict(state)
        grads = _to_moments(grads, state["opt"]["mu"])
        if tcfg.compress_grads:
            grads, new_state["err"] = _quantize_tree(grads, state["err"])
        _, opt, metrics = adamw_update(tcfg.opt, params, grads, state["opt"])
        new_state["opt"] = opt
        return new_state, {k: _host(v) for k, v in
                           dict(metrics, loss=loss).items()}

    return train_step
