"""Layers of the dense transformer: the port of ``repro.models.layers``
(norm, RoPE, MLP variants, grouped-query attention, full-sequence and one
cached decode step).

Tensors keep the reference's layouts: activations ``[B, S, D]``, heads
``[B, S, H, hd]``, weights ``[in, out]`` applied as ``x @ W``, KV caches
``[B, max_len, Hkv, hd]``. Full-sequence attention goes through
``repro_torch.kernels.ops.flash_attention`` (the hand-written kernel on the
card, its plain version on the CPU); the decode step against the cache is
plain torch, as the reference computes it outside any Pallas kernel. The
reference's ``constrain`` (a sharding hint, a no-op on one device) is
dropped; M-RoPE, sinusoidal positions, chunked prefill and cross attention
wait for the items that need them (ROADMAP.md queue 1 items 7, 8 and 9).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
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


def require_full_attention(cfg: ModelConfig) -> None:
    """Raise for the attention variants the port has no kernel path for."""
    if cfg.attn_window > 0 or cfg.attn_logit_softcap > 0:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window or soft-capped attention is not "
            f"ported yet: ROADMAP.md queue 1 item 9 (zamba2's attention)")


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def attention_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig):
    """Projected, rotated heads ``q [B,S,H,hd]``, ``k, v [B,S,Hkv,hd]``."""
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    if cfg.rope_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_type != "none":
        raise NotImplementedError(
            f"rope_type {cfg.rope_type!r} is not ported yet: ROADMAP.md "
            f"queue 1 item 7 (vlm, M-RoPE)")
    return q, k, v


def attention_out(params: Params, q, k, v, cfg: ModelConfig, causal: bool):
    """The attention core through the kernel (query head ``h`` reads KV head
    ``h // (H // Hkv)``, the reference's ``(n_kv, rep)`` grouping), then the
    output projection. q:[B,S,H,hd], k/v:[B,S,Hkv,hd] -> [B,S,D]."""
    require_full_attention(cfg)
    B, S = q.shape[:2]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return out @ params["wo"]


def multihead_attention(params: Params, x: torch.Tensor,
                        positions: torch.Tensor, cfg: ModelConfig, *,
                        causal: bool = True):
    """Full-sequence self-attention, x:[B,S,D] -> [B,S,D]."""
    q, k, v = attention_qkv(params, x, positions, cfg)
    return attention_out(params, q, k, v, cfg, causal)


def cached_attention_step(params: Params, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          index: Union[int, torch.Tensor], cfg: ModelConfig):
    """One decode step with a KV cache: x:[B,1,D], cache_k/v:[B,max_len,
    Hkv,hd]; returns the attention output [B,1,D].

    ``index`` is an int (lock-step decode: the whole batch at one position)
    or a ``[B]`` integer tensor (every row at its own position). The new K/V
    are written into the caches in place, at each row's position; the
    scores run against the whole cache with the keys past the position
    masked, as the reference computes them."""
    require_full_attention(cfg)
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
    if cfg.rope_type == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
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
    scores = scores / math.sqrt(hd)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    ok = kpos[None, :] <= pos                                    # [B, M]
    scores = scores.masked_fill(~ok[:, None, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrqm,bmkd->bqkrd", probs, cache_v)
    return out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]
