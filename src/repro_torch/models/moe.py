"""Top-k mixture-of-experts MLP: the port of ``repro.models.moe``.

Three dispatch implementations, as in the reference:

``sort``   (the model's) — group-local sort-based ragged dispatch. Tokens
           are routed within each group (a batch row in prefill, the whole
           batch in decode), sorted by expert (a stable sort), gathered into
           a dense ``[G, E, C, D]`` buffer (``C`` the per-group expert
           capacity; slots past it are dropped) and run through per-expert
           products; the outputs scatter-add back weighted by their gates.
``onehot`` — GShard's one-hot einsum dispatch, an oracle for the tests.
``dense``  — every expert on every token, an exact oracle for tiny tests.

The expert products are ``torch.einsum`` (batched matrix products over the
expert axis), as the reference computes them with einsums outside any
Pallas kernel. Every expert's weights are read whatever the routing: the
decode step reads all of them (``expert_capacity`` is ``top_k`` slots an
expert at a decode batch of 8), as the reference's does.
The router runs in fp32 whatever the model's dtype; its top-k takes
``lax.top_k``'s order (a stable descending sort, lower expert first on
equal gates).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, MoEConfig

Params = Dict[str, torch.Tensor]


def moe_params_shape(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                          str]]:
    """``name -> (shape, dtype name)`` of one layer's MoE parameters: the
    router ``[D, E]`` in fp32, the experts' ``w_gate``/``w_up`` ``[E, D, F]``
    and ``w_down`` ``[E, F, D]`` in the model's dtype."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    return {"router": ((d, e), "float32"),
            "w_gate": ((e, d, f), cfg.dtype),
            "w_up": ((e, d, f), cfg.dtype),
            "w_down": ((e, f, d), cfg.dtype)}


def expert_capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * m.top_k / m.num_experts
                  * m.capacity_factor)
    return max(int(c), m.top_k)


def _router(params: Params, x: torch.Tensor, m: MoEConfig):
    """Normalized top-k gate weights, expert ids and the full gates, in
    fp32. x: [..., D] -> ([..., k], [..., k], [..., E])."""
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :m.top_k], idx[..., :m.top_k]
    vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return vals, idx, gates


def aux_load_balance_loss(gates, idx, m: MoEConfig) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss."""
    e = m.num_experts
    top1 = F.one_hot(idx[..., 0], e).float()
    frac_tokens = top1.reshape(-1, e).mean(0)
    frac_prob = gates.reshape(-1, e).mean(0)
    return e * (frac_tokens * frac_prob).sum()


def _experts(params: Params, xin: torch.Tensor, activation: str):
    """Every expert's MLP over its slots, xin: [G, E, C, D] -> [G, E, C, D]."""
    h = torch.einsum("gecd,edf->gecf", xin, params["w_gate"])
    if activation == "swiglu":
        h = F.silu(h) * torch.einsum("gecd,edf->gecf", xin, params["w_up"])
    else:
        h = L.activation_fn(activation)(h)
    return torch.einsum("gecf,efd->gecd", h, params["w_down"])


def moe_apply_sort(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   with_aux: bool = True):
    """Group-local sort-based dispatch. x: [G, S, D] -> ([G, S, D], aux).

    Each group's ``S·k`` routed slots are stably sorted by expert; a slot's
    position within its expert's segment places it in the ``[E, C]``
    buffer, and a slot at position ``>= C`` is dropped (weight 0, token row
    ``S``, a zero padding row). ``with_aux=False`` skips the load-balancing
    loss (inference never reads it) and returns None in its place."""
    m = cfg.moe
    g, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = expert_capacity(s, m)
    dev = x.device
    vals, idx, gates = _router(params, x, m)            # [G,S,k]
    flat_e = idx.reshape(g, s * k)                      # expert of each slot
    flat_w = vals.reshape(g, s * k)
    flat_tok = torch.arange(s, device=dev).repeat_interleave(k)
    se, order = torch.sort(flat_e, dim=1, stable=True)
    stok, sw = flat_tok[order], torch.gather(flat_w, 1, order)
    # position of each routed slot within its expert segment
    start = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos = torch.arange(s * k, device=dev) - torch.gather(start, 1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)
    # slot -> token index table (E*C,) with padding row s; every kept slot
    # is written once, the dropped ones all land on the discarded row E*C
    slot_tok = torch.full((g, e * cap + 1), s, dtype=torch.long, device=dev)
    slot_tok.scatter_(1, slot, torch.where(keep, stok, s))
    slot_tok = slot_tok[:, :e * cap]
    slot_w = torch.zeros((g, e * cap + 1), dtype=torch.float32, device=dev)
    slot_w.scatter_(1, slot, torch.where(keep, sw, 0.0))
    slot_w = slot_w[:, :e * cap]
    xpad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1)
    rows = torch.arange(g, device=dev)[:, None]
    xin = xpad[rows, slot_tok].reshape(g, e, cap, d)     # [G,E,C,D]
    out = _experts(params, xin, cfg.activation)
    flat = out.reshape(g, e * cap, d) * slot_w[..., None].to(out.dtype)
    y = torch.zeros((g, s + 1, d), dtype=out.dtype, device=dev)
    y.scatter_add_(1, slot_tok[..., None].expand(g, e * cap, d), flat)
    aux = aux_load_balance_loss(gates, idx, m) if with_aux else None
    return y[:, :s], aux


def moe_apply_onehot(params: Params, x: torch.Tensor, cfg: ModelConfig,
                     with_aux: bool = True):
    """GShard one-hot einsum dispatch (an oracle for the tests)."""
    m = cfg.moe
    g, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = expert_capacity(s, m)
    vals, idx, gates = _router(params, x, m)
    combine = torch.zeros((g, s, e, cap), dtype=torch.float32,
                          device=x.device)
    counts = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    cslots = torch.arange(cap, device=x.device)
    for j in range(k):
        mask = F.one_hot(idx[..., j], e).float()         # [G,S,E]
        pos = torch.cumsum(mask, dim=1) - mask + counts[:, None, :]
        counts = counts + mask.sum(dim=1)
        keep = (pos < cap) * mask
        # a position past the capacity has no slot (jax.nn.one_hot's zeros)
        cpos = (pos.long()[..., None] == cslots).float()
        combine = combine + vals[..., j, None, None] * keep[..., None] * cpos
    dispatch = (combine > 0).to(x.dtype)
    xin = torch.einsum("gsec,gsd->gecd", dispatch, x)
    out = _experts(params, xin, cfg.activation)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), out)
    aux = aux_load_balance_loss(gates, idx, m) if with_aux else None
    return y, aux


def moe_apply_dense(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    with_aux: bool = True):
    """Every expert processes every token; exact oracle for tiny tests."""
    m = cfg.moe
    vals, idx, gates = _router(params, x, m)
    h = torch.einsum("gsd,edf->gsef", x, params["w_gate"])
    if cfg.activation == "swiglu":
        h = F.silu(h) * torch.einsum("gsd,edf->gsef", x, params["w_up"])
    else:
        h = L.activation_fn(cfg.activation)(h)
    out = torch.einsum("gsef,efd->gsed", h, params["w_down"])
    w = torch.zeros(gates.shape, dtype=torch.float32, device=x.device)
    for j in range(m.top_k):
        w = w + vals[..., j, None] * F.one_hot(idx[..., j],
                                               m.num_experts).float()
    y = torch.einsum("gsed,gse->gsd", out.float(), w).to(x.dtype)
    aux = aux_load_balance_loss(gates, idx, m) if with_aux else None
    return y, aux


MOE_IMPLS = {
    "sort": moe_apply_sort,
    "onehot": moe_apply_onehot,
    "dense": moe_apply_dense,
}


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              impl: str = "sort", with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    return MOE_IMPLS[impl](params, x, cfg, with_aux)
