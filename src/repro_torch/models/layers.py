"""Shared layers of the model zoo: the port of ``repro.models.layers``
(RMS and layer norms, RoPE and M-RoPE, sinusoidal positions, MLP variants,
grouped-query attention: full-sequence self and cross attention, one cached
decode step, one chunk of a chunked prefill, one cached cross-attention
step).

Tensors keep the reference's layouts: activations ``[B, S, D]``, heads
``[B, S, H, hd]``, weights ``[in, out]`` applied as ``x @ W``, KV caches
``[B, max_len, Hkv, hd]``. Full-sequence self-attention, causal or not and
with or without a sliding window, goes through
``repro_torch.kernels.ops.flash_attention`` (the hand-written kernel on the
card, its plain version on the CPU); cross attention, the decode step and
the prefill chunk against the cache are plain torch einsums, as the
reference computes them outside any Pallas kernel (their queries and keys
differ in length, which the kernel's contract does not take).

Under a device mesh the layers take DTensor activations and parameters
(``distributed.sharding``): the tables they build from positions (RoPE's
angles, M-RoPE's band selection) become replicated DTensors beside them,
and the attention kernel runs on each rank's local rows or heads. The
callers place the reference's ``constrain`` sharding hints.

Training: ``token_cross_entropy`` is the reference's loss; ``lm_loss``
computes the same mean from the hidden states and the head in row chunks
whose logits are recomputed in the backward (so a 200k-entry vocabulary
never holds a whole ``[B, S, V]`` logits tensor and its gradient);
``remat`` maps ``cfg.remat`` (``none | dots | full``) onto
``torch.utils.checkpoint`` (non-reentrant; ``dots`` keeps the weight
matrix products' outputs, the reference's
``checkpoint_dots_with_no_batch_dims``; the recomputation runs under the
forward's sharding rules).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed.sharding import (active_rules, is_dtensor,
                                              like, sharding_rules)
from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def cache_shapes(cache):
    """A cache of ``meta`` tensors with its host ints (``pos``) as 0-d
    int32 ``meta`` tensors: the shapes the reference's ``init_cache_shape``
    gives, leaf for leaf."""
    if isinstance(cache, dict):
        return {k: cache_shapes(v) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(cache_shapes(v) for v in cache)
    if isinstance(cache, int):
        return torch.empty((), dtype=torch.int32, device="meta")
    return cache


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMS norm in fp32 with the ``(1 + weight)`` scale (zero-initialised
    weights are the identity scale), cast back to ``x.dtype``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    """Layer norm in fp32 (population variance), cast back to
    ``x.dtype``."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (fp32)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S] int.
    Half-split rotation (not interleaved), angles in fp32, the result cast
    back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freqs = like(rope_freqs(x.shape[-1], theta, x.device), positions)
    ang = positions[..., None].float() * freqs           # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: Sequence[int]):
    """Multimodal RoPE (Qwen2-VL): x [B, S, H, D], positions_3d [3, B, S]
    (temporal, height, width). ``sections`` splits the half-dim into (t, h,
    w) frequency bands; band ``i`` rotates by stream ``i``'s angle, picked
    by a one-hot over the three streams as the reference does (a product by
    1 and two by 0: exact). For pure text the three streams are equal and
    this is ``apply_rope``."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"half the head dim {half}")
    freqs = like(rope_freqs(x.shape[-1], theta, x.device), positions_3d)
    ang = positions_3d[..., None].float() * freqs        # [3, B, S, half]
    idx = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                     for i, n in enumerate(sections)])
    onehot = like(F.one_hot(idx, 3).float().T, ang)      # [3, half]
    ang = (ang * onehot[:, None, None, :]).sum(0)        # [B, S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """``[seq_len, dim]`` fp32: sin in the even columns, cos in the odd,
    computed in float64 as the reference's numpy table."""
    pos = np.arange(seq_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((seq_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def activation_fn(name: str):
    if name == "swiglu":
        raise ValueError("swiglu is a gated MLP, not a pointwise activation")
    if name == "sq_relu":
        return lambda x: torch.relu(x).square()
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu
    raise ValueError(f"unknown activation {name}")


def mlp_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return {"w_up": (d, f), "w_down": (f, d)}


def mlp_apply(params: Params, x: torch.Tensor, activation: str):
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = activation_fn(activation)(x @ params["w_up"])
    return h @ params["w_down"]


def attn_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int):
    if is_dtensor(x):
        x = _whole_heads(x, n_heads)
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


class _MergeHeads(torch.autograd.Function):
    """``[B, S, H, hd] -> [B, S, H * hd]``, whose backward first gathers a
    DTensor gradient sharded into partial heads (a row-parallel product's
    input gradient: Phi-4-mini's 24 heads on a 16-way model dim)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            g = _whole_heads(g, ctx.shape[-2])
        return g.reshape(ctx.shape)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    if is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _whole_heads(x, n_heads: int, dim: int = -1):
    """A DTensor whose dim ``dim`` (heads, or heads x head dim) is sharded
    only over mesh dims that split it into whole groups of ``n_heads``: a
    column-parallel projection of 8 KV heads on a 16-way model dim leaves
    half a head a rank, which is gathered here first (the reference's
    GSPMD does the same)."""
    from torch.distributed.tensor import Replicate, Shard

    last = Shard(dim % x.ndim)
    want, m = [], 1
    for size, pl in zip(x.device_mesh.shape, x.placements):
        if pl == last and n_heads % (m * size) == 0:
            m *= size
            want.append(pl)
        else:
            want.append(Replicate() if pl == last else pl)
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def rotate(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, positions_3d: Optional[torch.Tensor] = None):
    """q and k rotated by the config's positions: M-RoPE where the config
    has it and ``positions_3d`` is given, else RoPE for ``rope`` and
    ``mrope`` configs (equal streams), else unchanged (``sinusoidal`` and
    ``none``: the positions are added to the input, or absent)."""
    if cfg.rope_type == "mrope" and positions_3d is not None:
        return (apply_mrope(q, positions_3d, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, positions_3d, cfg.rope_theta,
                            cfg.mrope_sections))
    if cfg.rope_type in ("rope", "mrope"):
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    return q, k


def attention_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, use_rope: bool = True,
                  positions_3d: Optional[torch.Tensor] = None):
    """Projected heads ``q [B,S,H,hd]``, ``k, v [B,S,Hkv,hd]``, q and k
    rotated (``rotate``) unless ``use_rope`` is false."""
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    if use_rope:
        q, k = rotate(q, k, positions, cfg, positions_3d)
    return q, k, v


def attention_out(params: Params, q, k, v, cfg: ModelConfig, causal: bool,
                  window: int = 0):
    """The attention core through the kernel (query head ``h`` reads KV head
    ``h // (H // Hkv)``, the reference's ``(n_kv, rep)`` grouping; keys
    ``j <= i - window`` masked when ``window > 0``; the logits soft-capped
    by ``cfg.attn_logit_softcap`` where it is set), then the output
    projection. q:[B,S,H,hd], k/v:[B,S,Hkv,hd] -> [B,S,D]."""
    B, S = q.shape[:2]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window,
                              softcap=cfg.attn_logit_softcap)
    out = _merge_heads(out.transpose(1, 2))
    return out @ params["wo"]


def multihead_attention(params: Params, x: torch.Tensor,
                        positions: torch.Tensor, cfg: ModelConfig, *,
                        causal: bool = True,
                        kv_x: Optional[torch.Tensor] = None,
                        use_rope: bool = True,
                        positions_3d: Optional[torch.Tensor] = None,
                        window: int = 0):
    """Full-sequence attention, x:[B,S,D] -> [B,S,D]: self-attention
    through the kernel; with ``kv_x [B,T,D]`` cross attention over it,
    unrotated and unmasked, as the reference's einsums compute it (the
    logits in the input dtype, scaled in fp32 and soft-capped where the
    config sets it, an fp32 softmax cast back before the product with
    v)."""
    if kv_x is None:
        q, k, v = attention_qkv(params, x, positions, cfg,
                                use_rope=use_rope, positions_3d=positions_3d)
        return attention_out(params, q, k, v, cfg, causal, window)
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)
    k = _split_heads(kv_x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(kv_x @ params["wv"], cfg.n_kv_heads, hd)
    if is_dtensor(q):
        out = _heads_local(_cross_core, q, k, v, cfg.attn_logit_softcap)
        return _merge_heads(out) @ params["wo"]
    return _cross_core(q, k, v, cfg.attn_logit_softcap).flatten(2) \
        @ params["wo"]


def _cross_core(q, k, v, softcap: float):
    """Unmasked attention of ``q [B,S,H,hd]`` over ``k, v [B,T,Hkv,hd]``
    as the reference's einsums compute it -> ``[B,S,H,hd]``."""
    B, S, H, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(B, S, kv, H // kv, hd)
    scores = torch.einsum("bqkrd,bmkd->bkrqm", q, k).float() / math.sqrt(hd)
    scores = ref.softcap_logits(scores, softcap)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkrqm,bmkd->bqkrd", probs, v).reshape(B, S, H, hd)


def _to(t, pl):
    """The DTensor ``t`` at placements ``pl``."""
    return t if list(t.placements) == list(pl) else \
        t.redistribute(t.device_mesh, pl)


def local_rows(fn: Callable, acts: Sequence, weights: Sequence = (),
               n_out: int = 1):
    """``fn(*acts, *weights)``, a computation over rows (every output row
    from the same input rows alone: projections, norms, gates), on each
    rank's own rows of the DTensor activations ``acts`` (placed alike; the
    outputs take their placements) with the ``weights`` gathered whole:
    stored sharded by their specs, gathered at use, their gradients (a
    partial sum over the ranks that hold other rows) reduce-scattered
    back. No tensor is reshaped and no operation runs at the DTensor
    level, whose rules differ between torch releases (the card's refuses
    a flatten of a sharded sequence, a roll, and a Partial sum beside a
    shard). A decode step gathers its weights too: its cost is in the
    dry-run's decode cells (PERF.md §5). Plain tensors: ``fn`` itself."""
    if not is_dtensor(acts[0]):
        return fn(*acts, *weights)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = acts[0].device_mesh
    # a pending sum (Partial) is reduced first: fn reads whole values
    pl = [p if isinstance(p, Shard) else Replicate()
          for p in acts[0].placements]
    rep = [Replicate()] * mesh.ndim
    summed = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    ws = [_to(w, rep) if is_dtensor(w) else like(w, acts[0])
          for w in weights]
    return local_map(
        fn, out_placements=(pl,) * n_out if n_out > 1 else pl,
        in_placements=(pl,) * len(acts) + (rep,) * len(ws),
        in_grad_placements=(pl,) * len(acts) + (summed,) * len(ws),
        device_mesh=mesh)(*(_to(a, pl) for a in acts), *ws)


def rows_placement(x):
    """The placements of ``x`` with its batch rows (dim 0) kept and every
    other dim gathered: the layout of a sequence gathered whole."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if p == Shard(0) else Replicate()
            for p in x.placements]


def row_span(x) -> Tuple[int, int]:
    """(first position, positions) of this rank's sequence rows of a
    ``[B, S, ...]`` DTensor (all of them when dim 1 is not sharded)."""
    rows = local_block(x)[1]
    return rows.start, rows.stop - rows.start


def local_block(t) -> Tuple[slice, ...]:
    """This rank's block of a DTensor: one slice a dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return tuple(slice(o, o + n) for o, n in zip(off, shape))


def assign(leaf: torch.Tensor, index: Tuple, value: torch.Tensor) -> None:
    """``leaf[index] = value`` in place, ``index`` a tuple over leading
    dims of ints and whole-dim slices (a layer of a stacked cache leaf;
    a ring buffer's slot). On a DTensor each rank writes its own block:
    the rank whose shard holds each int index (``cache_specs`` may shard a
    stacked dim) writes the part of ``value`` its shard covers; nothing
    runs at the DTensor level but the value's redistribution."""
    if not is_dtensor(leaf):
        leaf[index] = value
        return
    from torch.distributed.tensor import Replicate, Shard

    kept = [d for d, i in enumerate(index) if not isinstance(i, int)]
    kept += list(range(len(index), leaf.ndim))   # leaf dim of each value dim
    want = [Shard(kept.index(p.dim)) if isinstance(p, Shard)
            and p.dim in kept else Replicate() for p in leaf.placements]
    local = _to(value, want).to_local() if is_dtensor(value) else value
    at = []
    for i, b in zip(index, local_block(leaf)):
        if isinstance(i, int):
            if not b.start <= i < b.stop:
                return                 # another rank's shard holds it
            at.append(i - b.start)
        else:
            at.append(slice(None))
    leaf.to_local()[tuple(at)] = local.to(leaf.dtype)


def _heads_local(fn, q, k, v, *args):
    """``fn(q, k, v, *args)`` (an attention core, ``[B,S,H,hd]`` out) on
    each rank's own rows and heads: the batch over the mesh dims that
    shard q's rows, the heads over those that split both q's and the KV
    heads into whole groups (``_whole_heads``), everything else gathered.
    Each rank's result is its block of the output, so its gradients are
    its blocks of the inputs'."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    kv = k.shape[2]
    pl, m = [], 1
    for size, p in zip(mesh.shape, q.placements):
        if p == Shard(2) and kv % (m * size) == 0 and \
                q.shape[2] % (m * size) == 0:
            m *= size
            pl.append(p)
        else:
            pl.append(Shard(0) if p == Shard(0) else Replicate())
    return local_map(lambda *a: fn(*a, *args), out_placements=pl,
                     in_placements=(pl, pl, pl), device_mesh=mesh)(
        *(_to(t, pl) for t in (q, k, v)))


def cached_attention_step(params: Params, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          index: Union[int, torch.Tensor], cfg: ModelConfig,
                          *, window: int = 0,
                          positions_3d: Optional[torch.Tensor] = None):
    """One decode step with a KV cache: x:[B,1,D], cache_k/v:[B,max_len,
    Hkv,hd]; returns the attention output [B,1,D].

    ``index`` is an int (lock-step decode: the whole batch at one position)
    or a ``[B]`` integer tensor (every row at its own position). The new K/V
    are written into the caches in place, at each row's position; the
    scores run against the whole cache with the keys past the position
    (and, with ``window > 0``, those at or below ``pos - window``) masked,
    as the reference computes them. ``positions_3d [3, B, 1]`` rotates an
    M-RoPE config's q and k."""
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    per_row = isinstance(index, torch.Tensor) and index.dim() == 1
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)          # [B,1,H,hd]
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    if per_row:
        pos = index.to(device=x.device, dtype=torch.long).reshape(B, 1)
    else:
        pos = torch.full((B, 1), int(index), dtype=torch.long, device=x.device)
    pos = like(pos, x)
    q, k = rotate(q, k, pos, cfg, positions_3d)
    if is_dtensor(cache_k):
        _write_at(cache_k, k, pos)
        _write_at(cache_v, v, pos)
    elif per_row:
        rows = torch.arange(B, device=x.device)
        cache_k[rows, pos[:, 0]] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos[:, 0]] = v[:, 0].to(cache_v.dtype)
    else:
        cache_k[:, int(index)] = k[:, 0].to(cache_k.dtype)
        cache_v[:, int(index)] = v[:, 0].to(cache_v.dtype)
    kpos = like(torch.arange(cache_k.shape[1], device=x.device), x)
    ok = kpos[None, :] <= pos                                    # [B, M]
    if window > 0:
        ok &= kpos[None, :] > pos - window
    return attend_cached(q, cache_k, cache_v, ok,
                         cfg.attn_logit_softcap) @ params["wo"]


def attend_cached(q, cache_k, cache_v, ok, softcap: float = 0.0):
    """One query position against a cache: ``q [B,1,H,hd]`` over ``cache_k/v
    [B,M,Hkv,hd]`` where ``ok [B,M]`` (query head ``h`` reads KV head ``h //
    (H // Hkv)``), the logits scaled and soft-capped in fp32, an fp32
    softmax cast back before the product with v -> ``[B,1,H*hd]``.

    On DTensors each rank attends over its own cache shard (``_attend``):
    a cache sequence-sharded over "model" gives each rank a slice of the
    keys, and the softmax is taken across the slices by two small
    all-reduces (the rows' max and sum) and a third of the partial
    outputs, never gathering the cache."""
    if is_dtensor(q):
        return _attend_sharded(q, cache_k, cache_v, ok, softcap)
    return _attend(q, cache_k, cache_v, ok, softcap)


def _attend(q, k, v, ok, softcap: float, groups=()):
    """``attend_cached`` on local tensors; with ``groups`` (process groups
    over which the keys are split) the softmax spans every rank's keys."""
    import torch.distributed._functional_collectives as funcol

    B, _, H, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(B, 1, kv, H // kv, hd)
    scores = torch.einsum("bqkrd,bmkd->bkrqm", q, k).float()
    scores = ref.softcap_logits(scores / math.sqrt(hd), softcap)
    scores = scores.masked_fill(~ok[:, None, None, None, :], float("-inf"))
    if not groups:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkrqm,bmkd->bqkrd", probs, v)
        return out.reshape(B, 1, H * hd)
    top = scores.amax(-1, keepdim=True)
    for g in groups:
        top = funcol.wait_tensor(funcol.all_reduce(top, "max", g))
    e = torch.exp(scores - top)
    den = e.sum(-1, keepdim=True)
    for g in groups:
        den = funcol.wait_tensor(funcol.all_reduce(den, "sum", g))
    out = torch.einsum("bkrqm,bmkd->bqkrd", (e / den).to(q.dtype), v)
    for g in groups:
        out = funcol.wait_tensor(funcol.all_reduce(out, "sum", g))
    return out.reshape(B, 1, H * hd)


def _attend_sharded(q, k, v, ok, softcap: float):
    """``attend_cached`` on DTensors: the cache keeps its batch and
    sequence shards (any other sharded dim, such as the head dim, is
    gathered), q and ``ok`` take its batch shards, q's heads gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    kpl = [p if p in (Shard(0), Shard(1)) else Replicate()
           for p in k.placements]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in kpl]
    groups = tuple(mesh.get_group(i) for i, p in enumerate(kpl)
                   if p == Shard(1))
    return local_map(
        lambda *a: _attend(*a, softcap, groups), out_placements=rows,
        in_placements=(rows, kpl, kpl, kpl), device_mesh=mesh)(
        _to(q, rows), _to(k, kpl), _to(v, kpl), _to(like(ok, q), kpl))


def write_prefix(cache: torch.Tensor, new) -> None:
    """``cache[i, :, :S] = new[i]`` for every layer ``i`` of a DTensor
    ``[L, B, max_len, ...]`` cache and the layers' ``[B, S, ...]``
    values, in place and at once, as the reference's scan writes them.
    Each rank writes the positions its shard holds (``cache_specs``
    shards the sequence, and may shard the layer dim where it equals the
    batch): the values are gathered over the sequence first."""
    from torch.distributed.tensor import Replicate, Shard

    S = new[0].shape[1]
    want = [Replicate() if p == Shard(2) else p for p in cache.placements]
    vals = _to(torch.stack(new), want).to_local()
    seq = local_block(cache)[2]
    lo, hi = max(seq.start, 0), min(seq.stop, S)
    if lo < hi:
        cache.to_local()[:, :, lo - seq.start:hi - seq.start] = \
            vals[:, :, lo:hi].to(cache.dtype)


def placed_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` at ``ref``'s placements when ``ref`` is a DTensor (a value
    that replaces a cache leaf keeps the leaf's layout)."""
    return _to(t, ref.placements) if is_dtensor(ref) else t


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: a vocab-parallel lookup on a DTensor table."""
    if is_dtensor(table):
        return F.embedding(tokens.long(), table)
    return table[tokens.long()]


def _write_at(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """``cache[b, pos[b]] = new[b, 0]`` for a DTensor cache ``[B, M, Hkv,
    hd]`` whose sequence dim may be sharded: a select over the positions,
    so every rank writes its own shard in place (an indexed write would
    gather the sequence dim)."""
    kpos = like(torch.arange(cache.shape[1], device=pos.device), pos)
    hit = (kpos[None, :] == pos)[:, :, None, None]               # [B,M,1,1]
    cache.copy_(torch.where(hit, new.to(cache.dtype), cache))


def cached_attention_chunk(params: Params, x: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           offset: int, cfg: ModelConfig, *,
                           window: int = 0):
    """Chunked-prefill attention: the ``C`` prompt tokens ``x [B,C,D]`` at
    positions ``[offset, offset + C)`` attend causally to the earlier
    chunks already in ``cache_k/v [B,max_len,Hkv,hd]`` and to themselves.
    Their K/V are written into the caches in place at those positions;
    keys past each query's position are masked, so stale K/V of a slot's
    previous occupant is never attended; with ``window > 0`` so are keys
    at or below ``pos - window``. Returns the attention output ``[B,C,D]``,
    as the reference computes it."""
    hd = cfg.resolved_head_dim
    B, C = x.shape[:2]
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)          # [B,C,H,hd]
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    pos = offset + torch.arange(C, device=x.device)              # [C]
    q, k = rotate(q, k, pos[None, :].expand(B, C), cfg)
    cache_k[:, offset:offset + C] = k.to(cache_k.dtype)
    cache_v[:, offset:offset + C] = v.to(cache_v.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = q.reshape(B, C, cfg.n_kv_heads, n_rep, hd)
    scores = torch.einsum("bqkrd,bmkd->bkrqm", q, cache_k).float()
    scores = ref.softcap_logits(scores / math.sqrt(hd),
                                cfg.attn_logit_softcap)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    ok = kpos[None, :] <= pos[:, None]                           # [C, M]
    if window > 0:
        ok &= kpos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~ok[None, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrqm,bmkd->bqkrd", probs, cache_v)
    return out.reshape(B, C, cfg.n_heads * hd) @ params["wo"]


def cached_cross_attention_step(params: Params, x: torch.Tensor,
                                cross_k: torch.Tensor, cross_v: torch.Tensor,
                                cfg: ModelConfig):
    """Decode-time cross attention of ``x [B,1,D]`` against the encoder's
    precomputed ``cross_k/v [B,T,Hkv,hd]`` (query head ``h`` reads KV head
    ``h // (H // Hkv)``, as the reference's ``_repeat_kv``; on a mesh over
    each rank's cache shard, ``attend_cached``). Returns ``[B,1,D]``."""
    q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.resolved_head_dim)
    ok = like(torch.ones(cross_k.shape[:2], dtype=torch.bool,
                         device=x.device), q)
    return attend_cached(q, cross_k, cross_v, ok) @ params["wo"]


# -- training ------------------------------------------------------------------


def token_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the positions with ``label >= 0``, in fp32
    (the reference's ``token_cross_entropy``)."""
    return _nll_sum(logits, labels) / _n_labels(labels)


def _n_labels(labels: torch.Tensor) -> torch.Tensor:
    return (labels >= 0).sum().float().clamp(min=1.0)


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    mask = (labels >= 0).float()
    tgt = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - tgt) * mask).sum()


def _head_nll_sum(x, head, labels):
    return _nll_sum(x @ head, labels)


LOSS_CHUNK_ELEMS = 1 << 28   # logits a chunk of ``lm_loss`` (1 GiB in fp32)


def lm_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
            chunk_elems: int = LOSS_CHUNK_ELEMS) -> torch.Tensor:
    """``token_cross_entropy(x @ head, labels)`` for hidden states ``x
    [B,S,D]`` and the head ``[D,V]``, the logits taken in x's dtype as the
    reference takes them, over chunks of ``chunk_elems // V`` rows; with
    more than one chunk each is checkpointed, so only one chunk's logits
    exist at a time, forward or backward."""
    D, V = head.shape
    if is_dtensor(head):
        xf = _Pinned.apply(_batch_rows(x).reshape(-1, D))
        lf = _batch_rows(labels).reshape(-1)
        return _sharded_lm_loss(xf, head, lf) / _n_labels(labels)
    xf, lf = x.reshape(-1, D), labels.reshape(-1)
    rows = max(1, chunk_elems // V)
    if rows >= xf.shape[0]:
        return _head_nll_sum(xf, head, lf) / _n_labels(labels)
    total = x.new_zeros((), dtype=torch.float32)
    for r0 in range(0, xf.shape[0], rows):
        part = (xf[r0:r0 + rows], head, lf[r0:r0 + rows])
        total = total + (torch.utils.checkpoint.checkpoint(
            _head_nll_sum, *part, use_reentrant=False)
            if torch.is_grad_enabled() else _head_nll_sum(*part))
    return total / _n_labels(labels)


class _Pinned(torch.autograd.Function):
    """The identity on a DTensor whose gradient is redistributed to the
    input's placements: on a 3-d mesh DTensor may return the loss's row
    gradient split over the model dim too, which the unflatten of the
    rows back to ``[B, S, D]`` (the reshape's backward) cannot take."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _to(g, ctx.placements)


def _batch_rows(t):
    """A DTensor sharded along its batch dim alone (the sequence-parallel
    residual gathered), so that flattening batch and sequence keeps whole
    rows on each rank."""
    from torch.distributed.tensor import Replicate, Shard

    want = [pl if pl == Shard(0) or not isinstance(pl, Shard)
            else Replicate() for pl in t.placements]
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def _sharded_nll_sum(xf, head, lf):
    """``_nll_sum`` of DTensor rows against a vocab-sharded head, the
    logits kept sharded over the vocab: the log-sum-exp from each shard's
    max and sum (reduced across the shards), and the target logit from the
    shard that holds it (``_local_target``), summed across the shards."""
    from torch.distributed.tensor import Replicate

    logits = (xf @ head).float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    mask = (lf >= 0).float()
    nll = ((lse - _target_logits(logits, lf)) * mask).sum()
    return nll.redistribute(nll.device_mesh, [Replicate()] * nll.device_mesh.ndim)


def _target_logits(logits, labels):
    """``logits[r, labels[r]]`` of vocab-sharded DTensor logits: each rank
    picks the targets inside its vocab range (0 elsewhere), and the sum
    over the shards (a ``Partial`` placement) is the target logit; no rank
    gathers the vocab."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    out_pl = [Partial() if pl == Shard(1) else pl for pl in logits.placements]
    lab_pl = [Shard(0) if pl == Shard(0) else Replicate()
              for pl in logits.placements]

    def pick(local, lab):
        idx = lab.long() - offset[1]
        ok = (idx >= 0) & (idx < local.shape[1])
        got = local.gather(1, idx.clamp(0, local.shape[1] - 1)[:, None])[:, 0]
        return torch.where(ok, got, torch.zeros_like(got))

    labels = labels.redistribute(mesh, lab_pl)
    return local_map(pick, out_placements=out_pl,
                     in_placements=(logits.placements, lab_pl),
                     device_mesh=mesh)(logits, labels)


def _sharded_lm_loss(xf, head, lf):
    """The DTensor case of ``lm_loss``'s sum: one chunk of rows (each rank
    holds its own rows and vocab shard), checkpointed, so its logits are
    recomputed in the backward rather than kept."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            _sharded_nll_sum, xf, head, lf, use_reentrant=False)
    return _sharded_nll_sum(xf, head, lf)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def remat(fn: Callable, mode: str, *args):
    """``fn(*args)`` under ``cfg.remat``'s recomputation when autograd
    records it: ``none`` keeps every activation, ``full`` only the
    arguments (the block is recomputed in the backward), ``dots`` the
    arguments and the outputs of the weight products (``aten.mm`` /
    ``addmm``: the 2-d products, as the reference's policy keeps dots
    without batch dims), the rest recomputed."""
    if mode not in ("none", "dots", "full"):
        raise ValueError(f"remat {mode!r} not in none | dots | full")
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {"context_fn": _dots_context} if mode == "dots" else {}
    return torch.utils.checkpoint.checkpoint(_under(fn, active_rules()),
                                             *args, use_reentrant=False, **kw)


def _under(fn: Callable, rules) -> Callable:
    """``fn`` under the sharding rules of the forward that first ran it:
    its recomputation runs in the backward, on autograd's thread for a
    CUDA tensor, where this thread's rules are not active."""
    def run(*args):
        with sharding_rules(*rules):
            return fn(*args)
    return run
