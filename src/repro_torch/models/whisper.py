"""Whisper-style encoder-decoder backbone (arXiv:2212.04356): the port of
``repro.models.whisper``.

The conv/mel audio frontend is a stub, as in the reference: the caller
gives precomputed frame embeddings ``[B, T_enc, d_model]``. Positions are
sinusoidal on the encoder and the decoder, added to the input. The
encoder's self-attention (not causal) and the decoder's (causal) go through
``ops.flash_attention``; the decoder's cross attention over the encoder
output is plain torch (its queries and keys differ in length). A KV cache
holds the decoder's self-attention ``k``/``v``, the encoder's projected
``cross_k``/``cross_v`` and one position for the whole batch (the
reference decodes this family lock-step).

Training (``loss_fn``): the reference's token cross entropy of the decoder
over the encoder's output, every encoder and decoder layer recomputed in
the backward unless ``cfg.remat`` is ``none`` (the reference checkpoints
both scans whole, without a policy).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (ZooModel, dense_init_, param,
                                            param_dict, torch_dtype)


def _enc_layers(cfg: ModelConfig) -> int:
    return cfg.encoder_layers or cfg.n_layers


def _norm(d: int, device, dtype) -> nn.ParameterDict:
    return param_dict({"w": (d,), "b": (d,)}, device, dtype)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.attn = param_dict(L.attn_shapes(cfg), device, dtype)
        self.attn_norm = _norm(cfg.d_model, device, dtype)
        self.mlp = param_dict(L.mlp_shapes(cfg), device, dtype)
        self.mlp_norm = _norm(cfg.d_model, device, dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.self_attn = param_dict(L.attn_shapes(cfg), device, dtype)
        self.self_norm = _norm(cfg.d_model, device, dtype)
        self.cross_attn = param_dict(L.attn_shapes(cfg), device, dtype)
        self.cross_norm = _norm(cfg.d_model, device, dtype)
        self.mlp = param_dict(L.mlp_shapes(cfg), device, dtype)
        self.mlp_norm = _norm(cfg.d_model, device, dtype)


def _ln(x, p, eps):
    return L.layernorm(x, p["w"], p["b"], eps)


class Whisper(ZooModel):
    """The encoder-decoder; its tensors are uninitialised until ``init``
    fills them (on ``meta`` they are shapes only). ``device=None`` is the
    card; inputs must lie on the model's device."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = torch_dtype(cfg)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = param((v, d), device, dtype)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device, dtype)
                                     for _ in range(_enc_layers(cfg)))
        self.decoder = nn.ModuleList(DecoderLayer(cfg, device, dtype)
                                     for _ in range(cfg.n_layers))
        self.enc_final_norm = _norm(d, device, dtype)
        self.dec_final_norm = _norm(d, device, dtype)
        self.lm_head = param((d, v), device, dtype)

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    def _enc_layer(self, x, lp, positions):
        cfg = self.cfg
        h = _ln(x, lp.attn_norm, cfg.norm_eps)
        x = x + L.multihead_attention(lp.attn, h, positions, cfg,
                                      causal=False, use_rope=False)
        h = _ln(x, lp.mlp_norm, cfg.norm_eps)
        return x + L.mlp_apply(lp.mlp, h, cfg.activation)

    def encode(self, frames: torch.Tensor,
               remat: str = "none") -> torch.Tensor:
        """frames ``[B, T, d]`` -> the encoder output ``[B, T, d]``; each
        layer under ``remat`` (``layers.remat``)."""
        cfg = self.cfg
        x = self._on_device("frames", frames).to(self.lm_head.dtype)
        B, T, d = x.shape
        x = x + L.sinusoidal_positions(T, d, self.device).to(x.dtype)[None]
        positions = torch.arange(T, device=self.device).expand(B, T)
        for lp in self.encoder:
            x = L.remat(self._enc_layer, remat, x, lp, positions)
        return _ln(x, self.enc_final_norm, cfg.norm_eps)

    def _dec_layer(self, x, lp, positions, enc_out):
        """One decoder layer; returns its output and its self-attention
        ``k``, ``v``."""
        cfg = self.cfg
        h = _ln(x, lp.self_norm, cfg.norm_eps)
        q, k, v = L.attention_qkv(lp.self_attn, h, positions, cfg,
                                  use_rope=False)
        x = x + L.attention_out(lp.self_attn, q, k, v, cfg, True)
        h = _ln(x, lp.cross_norm, cfg.norm_eps)
        x = x + L.multihead_attention(lp.cross_attn, h, positions, cfg,
                                      causal=False, kv_x=enc_out,
                                      use_rope=False)
        h = _ln(x, lp.mlp_norm, cfg.norm_eps)
        return x + L.mlp_apply(lp.mlp, h, cfg.activation), k, v

    def _decoder_pass(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                      cache=None, remat: str = "none"):
        """The decoder over ``tokens [B,S]``; with a ``cache``, each layer's
        self-attention K/V are written to its first S positions; each
        layer under ``remat``."""
        cfg = self.cfg
        x = self.embed[self._on_device("tokens", tokens).long()]
        B, S, d = x.shape
        x = x + L.sinusoidal_positions(S, d, self.device).to(x.dtype)[None]
        positions = torch.arange(S, device=self.device).expand(B, S)
        for i, lp in enumerate(self.decoder):
            x, k, v = L.remat(self._dec_layer, remat, x, lp, positions,
                              enc_out)
            if cache is not None:
                cache["k"][i, :, :S] = k
                cache["v"][i, :, :S] = v
        return _ln(x, self.dec_final_norm, cfg.norm_eps)

    def forward(self, tokens: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward -> logits ``[B,S,V]``."""
        return self._decoder_pass(tokens, self.encode(frames)) @ self.lm_head

    def init_cache(self, batch: int, max_len: int) -> Dict:
        """Zeroed ``k``/``v`` ``[Ld, B, max_len, Hkv, hd]``, ``cross_k``/
        ``cross_v`` ``[Ld, B, encoder_seq, Hkv, hd]`` and ``pos`` 0."""
        cfg = self.cfg
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

        def zeros(n):
            return torch.zeros((cfg.n_layers, batch, n, kv, hd),
                               dtype=self.lm_head.dtype, device=self.device)

        return {"k": zeros(max_len), "v": zeros(max_len),
                "cross_k": zeros(cfg.encoder_seq),
                "cross_v": zeros(cfg.encoder_seq), "pos": 0}

    def prefill(self, tokens: torch.Tensor, cache: Dict,
                frames: torch.Tensor):
        """Encode ``frames [B,T,d]`` and run the prompt ``[B,S]`` through
        the decoder: its self-attention K/V go into ``cache`` in place, the
        encoder's projected K/V become ``cross_k``/``cross_v`` and ``pos``
        becomes S. Returns ``(last-position logits [B,V], cache)``."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        enc_out = self.encode(frames)
        x = self._decoder_pass(tokens, enc_out, cache)
        cache["cross_k"] = torch.stack([
            L._split_heads(enc_out @ lp.cross_attn["wk"], cfg.n_kv_heads, hd)
            for lp in self.decoder])
        cache["cross_v"] = torch.stack([
            L._split_heads(enc_out @ lp.cross_attn["wv"], cfg.n_kv_heads, hd)
            for lp in self.decoder])
        cache["pos"] = tokens.shape[1]
        return (x[:, -1:] @ self.lm_head)[:, 0], cache

    def decode_step(self, tokens: torch.Tensor, cache: Dict):
        """One-token decode, tokens ``[B,1]``, at the cache's position
        (an int): adds that index's sinusoidal position, writes the new K/V
        in place. Returns ``(logits [B,V], cache)``."""
        cfg = self.cfg
        x = self.embed[self._on_device("tokens", tokens).long()]   # [B,1,d]
        index = cache["pos"]
        d = cfg.d_model
        half = d // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=self.device)
                          * (-math.log(10000.0) / half))
        ang = float(index) * freqs
        pe = torch.stack([torch.sin(ang), torch.cos(ang)], 1).reshape(-1)[:d]
        x = x + pe[None, None].to(x.dtype)
        for i, lp in enumerate(self.decoder):
            h = _ln(x, lp.self_norm, cfg.norm_eps)
            x = x + L.cached_attention_step(lp.self_attn, h, cache["k"][i],
                                            cache["v"][i], index, cfg)
            h = _ln(x, lp.cross_norm, cfg.norm_eps)
            x = x + L.cached_cross_attention_step(
                lp.cross_attn, h, cache["cross_k"][i], cache["cross_v"][i],
                cfg)
            h = _ln(x, lp.mlp_norm, cfg.norm_eps)
            x = x + L.mlp_apply(lp.mlp, h, cfg.activation)
        cache["pos"] = index + 1
        x = _ln(x, self.dec_final_norm, cfg.norm_eps)
        return (x @ self.lm_head)[:, 0], cache


def loss_fn(model: Whisper, batch: Dict,
            aux_weight: float = 0.0) -> torch.Tensor:
    """The reference's ``loss_fn``: mean token cross entropy of the decoder
    over ``batch["tokens"]`` and the encoder over ``batch["frames"]``
    against ``batch["labels"]`` (no auxiliary loss: ``aux_weight`` is
    unused, as there)."""
    remat = "none" if model.cfg.remat == "none" else "full"
    x = model._decoder_pass(batch["tokens"],
                            model.encode(batch["frames"], remat),
                            remat=remat)
    return L.lm_loss(x, model.lm_head, batch["labels"])


def logits(model: Whisper, batch: Dict) -> torch.Tensor:
    return model(batch["tokens"], batch["frames"])


Model = Whisper


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, device=None) -> Whisper:
    """A model with random weights from ``seed``, drawn by a
    ``torch.Generator`` on ``device`` (``None`` is the card): layer-norm
    weights one and biases zero, the embedding N(0, 0.02), every matrix
    truncated normal with fan-in scale, as the reference's ``init``. The
    numbers differ from the reference's ``jax.random`` draw."""
    model = Whisper(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if "norm" in name:
            p.fill_(1.0 if name.endswith(".w") else 0.0)
        elif name == "embed":
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    * 0.02)
        else:
            dense_init_(p, gen)
    return model
