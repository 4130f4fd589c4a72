"""Zamba2 hybrid: Mamba2 backbone + one shared attention block
(arXiv:2411.15242), the port of ``repro.models.zamba2``.

``n_layers`` Mamba2 blocks form G = n_layers / shared_attn_every groups;
after each group the single shared attention + MLP block runs (the same
parameters every time). The shared block's attention has a sliding window
(``cfg.attn_window``): its prefill goes through ``ops.flash_attention``
with that window, and each of the G applications keeps its own
ring-buffered KV cache of ``M = min(max_len, window)`` slots, slot
``position % M``. As in the reference, the released checkpoints'
per-application LoRA deltas on the shared block are omitted.

Training (``loss_fn``): the reference's token cross entropy, each group
(its Mamba2 layers and the shared block) recomputed in the backward unless
``cfg.remat`` is ``none``.

On a mesh the residual is sequence-parallel: the Mamba2 layers as
``mamba2.block_forward`` places them, the shared block as the dense
transformer's (its windowed attention through the kernel's DTensor
rules); the states and ring buffers under ``cache_specs``, each rank
writing its own shard (``layers.assign``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed.sharding import constrain, like
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Block, ZooModel, dense_init_,
                                            param, param_dict, torch_dtype)


def _groups(cfg: ModelConfig):
    every = cfg.shared_attn_every
    assert cfg.n_layers % every == 0, (cfg.n_layers, every)
    return cfg.n_layers // every, every


def _kv_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.attn_window) if cfg.attn_window else max_len


class Zamba2(ZooModel):
    """The hybrid; its tensors are uninitialised until ``init`` fills them
    (on ``meta`` they are shapes only). ``mamba[g * E + e]`` is layer ``e``
    of group ``g`` (the reference's ``[G, E, ...]`` leaves); ``shared`` is
    a transformer ``Block`` (attention with the window, then the MLP).
    ``device=None`` is the card; inputs must lie on the model's device."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _groups(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        dtype = torch_dtype(cfg)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = param((v, d), device, dtype)
        self.mamba = nn.ModuleList(
            param_dict(mamba2.params_shape(cfg), device, dtype)
            for _ in range(cfg.n_layers))
        self.shared = Block(cfg, device, dtype)
        self.final_norm = param(d, device, dtype)
        self.lm_head = param((d, v), device, dtype)

    def _tokens(self, tokens):
        """Token ids -> the residual (sequence-parallel on a mesh)."""
        return constrain(L.embed_tokens(self.embed, self._on_device(
            "tokens", tokens)), "batch", "seq", "embed")

    def _head(self, x):
        x = constrain(L.rmsnorm(x, self.final_norm, self.cfg.norm_eps),
                      "batch", None, "embed")
        return constrain(x @ self.lm_head, "batch", None, "vocab")

    def _groups_forward(self, x, cache=None):
        """The G groups over ``x [B,S,d]``; with a ``cache``, each Mamba2
        layer's final state and each shared block's rotated K/V (ring
        buffered) are written to it."""
        cfg = self.cfg
        G, E = _groups(cfg)
        B, S = x.shape[:2]
        positions = like(torch.arange(S, device=self.device).expand(B, S), x)
        for g in range(G):
            for e in range(E):
                x, st = mamba2.block_forward(x, self.mamba[g * E + e], cfg)
                x = constrain(x, "batch", "seq", "embed")
                if cache is not None:
                    for name, t in st.items():
                        L.assign(cache["mamba"][name], (g, e), t)
            x, k, v, _ = self.shared(x, positions, True)
            if cache is not None:
                self._keep_window(cache, g, k, v)
        return x

    @staticmethod
    def _keep_window(cache, g, k, v):
        """The prompt's K/V ``[B,S,Hkv,hd]`` into group g's ring buffer of
        M slots: the last M positions, rolled so that slot = position % M
        (S >= M), or the first S slots and zeros after (S < M)."""
        M, S = cache["k"].shape[2], k.shape[1]
        for name, t in (("k", k), ("v", v)):
            if S >= M:   # t[:, S - M:] rolled right by S % M (two slices:
                # DTensor has no rule for roll)
                last, r = t[:, S - M:], S % M
                ring = torch.cat([last[:, M - r:], last[:, :M - r]], 1)
            else:
                ring = torch.cat([t, t.new_zeros((t.shape[0], M - S,
                                                  *t.shape[2:]))], 1)
            L.assign(cache[name], (g,), ring)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward -> logits ``[B,S,V]``."""
        return self._head(self._groups_forward(self._tokens(tokens)))

    def init_cache(self, batch: int, max_len: int) -> Dict:
        """Zeroed Mamba2 states ``ssm [G, E, B, nh, P, N]`` (fp32) and
        ``conv [G, E, B, W-1, C]``, ring buffers ``k``/``v`` ``[G, B, M,
        Hkv, hd]`` with ``M = min(max_len, window)``, and ``pos`` 0."""
        cfg = self.cfg
        G, E = _groups(cfg)
        dtype = self.final_norm.dtype
        st = mamba2.state(cfg, batch, dtype, self.device)
        shape = (G, batch, _kv_len(cfg, max_len), cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"mamba": {name: t.expand(G, E, *t.shape).clone()
                          for name, t in st.items()},
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "pos": 0}

    def prefill(self, tokens: torch.Tensor, cache: Dict):
        """The prompt ``[B,S]`` through the model, filling the Mamba2
        states and the window caches in place; ``pos`` becomes S. Returns
        ``(last-position logits [B,V], cache)``."""
        x = self._groups_forward(self._tokens(tokens), cache)
        cache["pos"] = tokens.shape[1]
        return self._head(x[:, -1:])[:, 0], cache

    def _shared_step(self, x, cache, g: int, pos: int):
        """The shared block on one token at position ``pos`` (a host int)
        against group g's ring buffer ``[B,M,Hkv,hd]``: the new K/V go to
        slot ``pos % M`` (on a mesh each rank writes its shard of the
        buffer); slot j is attended while ``j <= pos``, every slot once
        ``pos >= M`` (``layers.attend_cached``)."""
        cfg = self.cfg
        sp = self.shared
        B, M = x.shape[0], cache["k"].shape[2]
        h = L.rmsnorm(x, sp.attn_norm, cfg.norm_eps)
        p = like(torch.full((B, 1), pos, dtype=torch.long, device=x.device),
                 x)
        q, k, v = L.attention_qkv(sp.attn, h, p, cfg)
        for name, new in (("k", k), ("v", v)):
            L.assign(cache[name], (g, slice(None), pos % M), new[:, 0])
        ok = like(torch.arange(M, device=x.device)[None, :].expand(B, M)
                  <= pos, x)
        x = x + L.attend_cached(q, cache["k"][g], cache["v"][g], ok,
                                cfg.attn_logit_softcap) @ sp.attn["wo"]
        h = L.rmsnorm(x, sp.mlp_norm, cfg.norm_eps)
        return x + L.mlp_apply(sp.mlp, h, cfg.activation)

    def decode_step(self, tokens: torch.Tensor, cache: Dict):
        """One-token decode, tokens ``[B,1]`` at the cache's position (an
        int): every Mamba2 layer's recurrent step, then the shared block
        against its group's ring buffer; states are replaced, K/V written
        in place. Returns ``(logits [B,V], cache)``."""
        cfg = self.cfg
        G, E = _groups(cfg)
        x = self._tokens(tokens)
        pos = cache["pos"]
        ms = cache["mamba"]
        for g in range(G):
            for e in range(E):
                x, st = mamba2.block_step(
                    x, self.mamba[g * E + e], cfg,
                    {name: t[g, e] for name, t in ms.items()})
                for name, t in st.items():
                    L.assign(ms[name], (g, e), t)
            x = self._shared_step(x, cache, g, pos)
        cache["pos"] = pos + 1
        return self._head(x)[:, 0], cache


def _train_group(model: Zamba2, x: torch.Tensor, g: int,
                 positions: torch.Tensor) -> torch.Tensor:
    """Group ``g``'s Mamba2 layers, then the shared block (causal, with
    the config's window)."""
    cfg = model.cfg
    G, E = _groups(cfg)
    for e in range(E):
        x = constrain(mamba2.block_forward(x, model.mamba[g * E + e], cfg)[0],
                      "batch", "seq", "embed")
    return model.shared(x, positions, True)[0]


def loss_fn(model: Zamba2, batch: Dict,
            aux_weight: float = 0.0) -> torch.Tensor:
    """The reference's ``loss_fn``: mean token cross entropy of the
    forward over ``batch["tokens"]`` against ``batch["labels"]``
    (``aux_weight`` unused, as there)."""
    cfg = model.cfg
    remat = "none" if cfg.remat == "none" else "full"
    x = model._tokens(batch["tokens"])
    B, S = x.shape[:2]
    positions = like(torch.arange(S, device=model.device).expand(B, S), x)
    for g in range(_groups(cfg)[0]):
        x = L.remat(_train_group, remat, model, x, g, positions)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.lm_loss(x, model.lm_head, batch["labels"])


def logits(model: Zamba2, batch: Dict) -> torch.Tensor:
    return model(batch["tokens"])


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """The cache ``init_cache`` makes, on ``meta`` (shapes only)."""
    model = Zamba2(cfg, device="meta")
    return L.cache_shapes(model.init_cache(batch, max_len))


Model = Zamba2


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, device=None) -> Zamba2:
    """A model with random weights from ``seed``, drawn by a
    ``torch.Generator`` on ``device`` (``None`` is the card), as the
    reference's ``init``: the embedding N(0, 0.02), norms zero, the Mamba2
    layers as ``mamba2.init_``, every other matrix truncated normal with
    fan-in scale. The numbers differ from the reference's ``jax.random``
    draw."""
    model = Zamba2(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for lp in model.mamba:
        mamba2.init_(lp, gen, dense_init_)
    for name, p in model.named_parameters():
        if name.startswith("mamba."):
            continue
        if "norm" in name:
            p.zero_()
        elif name == "embed":
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    * 0.02)
        else:
            dense_init_(p, gen)
    return model
