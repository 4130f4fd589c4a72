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
differ in length, which the kernel's contract does not take). The
reference's ``constrain`` (a sharding hint, a no-op on one device) is
dropped.

Training: ``token_cross_entropy`` is the reference's loss; ``lm_loss``
computes the same mean from the hidden states and the head in row chunks
whose logits are recomputed in the backward (so a 200k-entry vocabulary
never holds a whole ``[B, S, V]`` logits tensor and its gradient);
``remat`` maps ``cfg.remat`` (``none | dots | full``) onto
``torch.utils.checkpoint`` (non-reentrant; ``dots`` keeps the weight
matrix products' outputs, the reference's
``checkpoint_dots_with_no_batch_dims``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


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
    freqs = rope_freqs(x.shape[-1], theta, x.device)
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
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions_3d[..., None].float() * freqs        # [3, B, S, half]
    idx = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                     for i, n in enumerate(sections)])
    onehot = F.one_hot(idx, 3).float().T                 # [3, half]
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
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


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
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
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
    B, S = x.shape[:2]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)
    k = _split_heads(kv_x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(kv_x @ params["wv"], cfg.n_kv_heads, hd)
    q = q.reshape(B, S, cfg.n_kv_heads, n_rep, hd)
    scores = torch.einsum("bqkrd,bmkd->bkrqm", q, k).float() / math.sqrt(hd)
    scores = ref.softcap_logits(scores, cfg.attn_logit_softcap)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrqm,bmkd->bqkrd", probs, v)
    return out.reshape(B, S, cfg.n_heads * hd) @ params["wo"]


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
    q, k = rotate(q, k, pos, cfg, positions_3d)
    if per_row:
        rows = torch.arange(B, device=x.device)
        cache_k[rows, pos[:, 0]] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos[:, 0]] = v[:, 0].to(cache_v.dtype)
    else:
        cache_k[:, int(index)] = k[:, 0].to(cache_k.dtype)
        cache_v[:, int(index)] = v[:, 0].to(cache_v.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = q.reshape(B, 1, cfg.n_kv_heads, n_rep, hd)
    scores = torch.einsum("bqkrd,bmkd->bkrqm", q, cache_k).float()
    scores = ref.softcap_logits(scores / math.sqrt(hd),
                                cfg.attn_logit_softcap)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    ok = kpos[None, :] <= pos                                    # [B, M]
    if window > 0:
        ok &= kpos[None, :] > pos - window
    scores = scores.masked_fill(~ok[:, None, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrqm,bmkd->bqkrd", probs, cache_v)
    return out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]


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
    precomputed ``cross_k/v [B,T,Hkv,hd]`` (K/V repeated over the query
    groups where there are several, as the reference's ``_repeat_kv``).
    Returns ``[B,1,D]``."""
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kk, vv = cross_k, cross_v
    if n_rep > 1:
        kk = kk.repeat_interleave(n_rep, dim=2)
        vv = vv.repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    return out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]


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
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kw)
