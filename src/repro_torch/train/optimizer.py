"""AdamW with linear warmup, cosine decay and global-norm clipping: the port
of ``repro.train.optimizer``.

Moments are fp32 whatever the parameters' dtype; parameters keep theirs.
The update runs in place, leaf by leaf (the reference returns new trees):
at 4.45 B parameters a second copy of the parameters and moments would not
fit beside them on one card, and in place the update's temporaries are a
few fp32 copies of the largest leaf. The schedule and bias corrections are
fp32 scalars on the host, as the reference computes them in fp32.

The parameters, gradients and moments are dicts ``name -> tensor`` with
one key set (``train_step`` takes the model's ``named_parameters``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay: an fp32 scalar on the host."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def fp32_zeros(params: Tree, specs=None, mesh=None) -> Tree:
    """A zero fp32 tensor the shape of each parameter; with a mesh, a
    DTensor placed by ``specs`` (``{name: spec}``)."""
    if mesh is None:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    from repro_torch.distributed.partition import zeros_placed

    return {n: zeros_placed(p.shape, torch.float32, p.device, mesh, specs[n])
            for n, p in params.items()}


def adamw_init(params: Tree, specs=None, mesh=None) -> Dict[str, object]:
    """Zero fp32 moments beside each parameter and step 0 (an int32 host
    scalar). With a mesh, each moment is a DTensor placed by ``specs``
    (``distributed.partition.opt_state_specs``' ``mu``)."""
    return {"mu": fp32_zeros(params, specs, mesh),
            "nu": fp32_zeros(params, specs, mesh),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float32)
                          .square() for g in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: Dict[str, object]
                 ) -> Tuple[Tree, Dict[str, object], Dict[str, torch.Tensor]]:
    """One optimizer step, in place; returns ``(params, state, metrics)``
    with ``metrics`` ``grad_norm`` (before clipping) and ``lr``. Decoupled
    weight decay applies to matrices only (``ndim >= 2``).

    DTensor leaves (a sharded train state) take the same arithmetic: the
    norm is global over every shard, each moment updates on its own shard
    (its gradient at its placement), and the parameter takes its update
    at its own placement. The host scalars enter as Python floats (their
    fp32 values), which DTensor mixes with its tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0 else None)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = float(1 - cfg.b1 ** stepf)
    bc2 = float(1 - cfg.b2 ** stepf)
    mus, nus = state["mu"], state["nu"]
    for name, p in params.items():
        g = grads[name].float()
        g = g * scale if scale is not None else g
        mu, nu = mus[name], nus[name]
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float().sub_(float(lr) * delta))
        del delta
    return params, {"mu": mus, "nu": nus, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
