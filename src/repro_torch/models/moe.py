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

On a mesh (DTensor activations) the sort dispatch runs expert-parallel
(``_moe_sort_sharded``): the experts split over "model", every rank
routing whole groups and running its own experts' products.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, is_dtensor
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


class _Drops(threading.local):
    def __init__(self):
        self.counts: Optional[Dict[str, int]] = None


_DROPS = _Drops()


@contextmanager
def count_drops():
    """Count, in the MoE layers that run inside (this thread only), the
    routed slots and those dropped past capacity, by the experts this
    rank holds (all of them unsharded): yields ``{"routed": n,
    "dropped": n}``. Each layer reads its count back to the host, so
    count in a forward pass, not a timed step."""
    prev = _DROPS.counts
    _DROPS.counts = {"routed": 0, "dropped": 0}
    try:
        yield _DROPS.counts
    finally:
        _DROPS.counts = prev


def _dispatch(experts: Params, x: torch.Tensor, vals: torch.Tensor,
              idx: torch.Tensor, cfg: ModelConfig, e0: int = 0):
    """The sort dispatch of routed tokens ``x [G,S,D]`` (gates ``vals``,
    expert ids ``idx`` ``[G,S,k]``) through the experts ``e0 ..
    e0 + E_loc - 1`` whose weights ``experts`` holds (``[E_loc, ...]``):
    ``[G,S,D]``, the sum of those experts' gated outputs (all of them when
    ``E_loc`` is the config's ``E``).

    Each group's ``S·k`` routed slots are stably sorted by expert; a
    slot's position within its expert's segment places it in the ``[E, C]``
    buffer, and a slot at position ``>= C`` is dropped (weight 0, token
    row ``S``, a zero padding row). Only the held experts' slots are
    gathered and run."""
    m = cfg.moe
    g, s, d = x.shape
    e, k = m.num_experts, m.top_k
    e_loc = experts["w_gate"].shape[0]
    cap = expert_capacity(s, m)
    dev = x.device
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
    slot_w = torch.zeros((g, e * cap + 1), dtype=torch.float32, device=dev)
    slot_w.scatter_(1, slot, torch.where(keep, sw, 0.0))
    held = slice(e0 * cap, (e0 + e_loc) * cap)
    slot_tok, slot_w = slot_tok[:, held], slot_w[:, held]
    if _DROPS.counts is not None:   # the held experts' routes, and drops
        per = F.one_hot(flat_e, e).sum(1)[:, e0:e0 + e_loc]    # [G,E_loc]
        _DROPS.counts["routed"] += int(per.sum())
        _DROPS.counts["dropped"] += int((per - cap).clamp(min=0).sum())
    xpad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1)
    rows = torch.arange(g, device=dev)[:, None]
    xin = xpad[rows, slot_tok].reshape(g, e_loc, cap, d)  # [G,E_loc,C,D]
    out = _experts(experts, xin, cfg.activation)
    flat = out.reshape(g, e_loc * cap, d) * slot_w[..., None].to(out.dtype)
    y = torch.zeros((g, s + 1, d), dtype=out.dtype, device=dev)
    y.scatter_add_(1, slot_tok[..., None].expand(g, e_loc * cap, d), flat)
    return y[:, :s]


def moe_apply_sort(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   with_aux: bool = True):
    """Group-local sort-based dispatch (``_dispatch``). x: [G, S, D] ->
    ([G, S, D], aux). ``with_aux=False`` skips the load-balancing loss
    (inference never reads it) and returns None in its place. A DTensor
    ``x`` runs expert-parallel (``_moe_sort_sharded``)."""
    if is_dtensor(x):
        return _moe_sort_sharded(params, x, cfg, with_aux)
    vals, idx, gates = _router(params, x, cfg.moe)      # [G,S,k]
    y = _dispatch(params, x, vals, idx, cfg)
    aux = aux_load_balance_loss(gates, idx, cfg.moe) if with_aux else None
    return y, aux


def _moe_sort_sharded(params: Params, x, cfg: ModelConfig, with_aux: bool):
    """Expert parallelism: the sort dispatch on a mesh, its experts
    sharded over "model" (``partition``'s specs).

    Capacity is counted over a whole group, so every rank routes whole
    groups: ``x`` is constrained to ``("batch", None, "embed")``, its
    groups over the data dims where they divide them and its sequence
    gathered (a training or prefill row is sequence-sharded before it; a
    decode step's one group, the batch, is gathered across the data
    ranks). Each rank then routes its groups (the router, gathered, in
    fp32: the same top-k on every model rank), builds only its own
    experts' slots of the ``[G, E, C, D]`` buffer, runs their products and
    scatter-adds their gated outputs into a ``[G, S, D]`` partial sum
    over the model ranks, which the caller's constrain reduce-scatters
    onto the sequence-parallel residual (or all-reduces in decode).

    What each rank sends: its sequence slice of the normed residual in the
    all-gather before the layer, the router's ``[D, E/m]`` shard, and its
    ``[G, S, D]`` partial output in the reduce-scatter after it; no token
    crosses ranks by an all-to-all. The backward mirrors it (the
    reduce-scatter's gradient is an all-gather, the gather's a
    reduce-scatter). The load-balancing loss takes its two per-expert
    means over every token of the global batch (sums all-reduced over
    the data ranks), not a mean of per-rank losses."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    m = cfg.moe
    e = m.num_experts
    x = constrain(x, "batch", None, "embed")
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    xpl = list(x.placements)
    router = params["router"]
    if is_dtensor(router):
        router = router.redistribute(mesh, rep)
    names = ("w_gate", "w_up", "w_down")
    # the experts split where every stack is expert-sharded (the specs
    # shard a count of experts the model dim does not divide by other
    # dims, which are gathered here)
    wpl = [p if all(params[n].placements[i] == Shard(0) for n in names)
           else Replicate() for i, p in enumerate(params["w_gate"].placements)]
    ws = [L._to(params[n], wpl) for n in names]
    _, off = compute_local_shape_and_global_offset(ws[0].shape, mesh, wpl)
    e0 = off[0]
    # the experts' sum crosses the model ranks that split the experts
    ypl = [Partial() if w == Shard(0) else p for w, p in zip(wpl, xpl)]
    # a weight's gradient from this rank's groups is a partial sum over
    # the data ranks that route other groups
    def summed(pl):
        return [Partial() if p == Shard(0) else w for w, p in zip(pl, xpl)]

    vals, idx, gates = local_map(
        lambda xl, rl: _router({"router": rl}, xl, m),
        out_placements=(xpl, xpl, xpl), in_placements=(xpl, rep),
        in_grad_placements=(xpl, summed(rep)), device_mesh=mesh)(x, router)

    def dispatch(xl, vl, il, *wl):
        return _dispatch(dict(zip(names, wl)), xl, vl, il, cfg, e0)

    y = local_map(dispatch, out_placements=ypl,
                  in_placements=(xpl, xpl, xpl, wpl, wpl, wpl),
                  in_grad_placements=(ypl, ypl, xpl, *[summed(wpl)] * 3),
                  device_mesh=mesh)(x, vals, idx, *ws)
    if not with_aux:
        return y, None
    # the two per-expert sums over this rank's groups: a partial sum over
    # the data ranks that hold other groups
    spl = [Partial() if p == Shard(0) else Replicate() for p in xpl]

    def sums(gl, il):
        return (F.one_hot(il[..., 0], e).float().reshape(-1, e).sum(0),
                gl.reshape(-1, e).sum(0))

    tok, prob = local_map(sums, out_placements=(spl, spl),
                          in_placements=(xpl, xpl),
                          device_mesh=mesh)(gates, idx)
    n = x.shape[0] * x.shape[1]
    tok, prob = tok.redistribute(mesh, rep), prob.redistribute(mesh, rep)
    return y, e * ((tok / n) * (prob / n)).sum()


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
    if impl != "sort" and is_dtensor(x):
        raise ValueError(f"the {impl!r} dispatch is a test oracle: on a "
                         f"mesh the MoE runs the sort dispatch")
    return MOE_IMPLS[impl](params, x, cfg, with_aux)
