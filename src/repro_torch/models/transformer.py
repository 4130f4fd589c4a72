"""Decoder-only GQA transformer, dense, MoE and VLM-backbone families: the
port of ``repro.models.transformer``.

``Transformer`` is an ``nn.Module`` with one ``Block`` per layer in a
``ModuleList`` where the reference stacks ``[L, ...]`` leaves and scans
them. Weights keep the reference's layout (``x @ W`` with ``W [in, out]``;
the embedding ``[vocab, d]``, its transpose the LM head when tied), so a
JAX parameter tree goes across as copies (``repro_torch.convert``).
Parameters are made inference-only (serving); training turns them
trainable (``repro_torch.train.train_step``) and takes its loss from
``loss_fn``: the causal forward with every block under ``cfg.remat``, the
MoE blocks' load-balancing loss weighted ``aux_weight``, and the
reference's token cross entropy from the hidden states
(``layers.lm_loss``).

An MoE config (``cfg.moe``) puts ``repro_torch.models.moe``'s sort
dispatch in every block's MLP slot (``Block.moe``: the router in fp32, the
experts in the model's dtype). Its routing groups are the reference's: a
batch row in ``prefill`` and ``prefill_chunk``, the whole batch in
``decode_step``.

A ``vlm`` config (Qwen2-VL) takes precomputed embeddings ``[B, S, D]`` in
place of token ids (its patch frontend is a stub, as in the reference; the
model has no embedding table) and rotates q and k by M-RoPE over
``positions_3d [3, B, S]`` (temporal, height, width), which default to the
token positions in all three streams, as the reference derives them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def param(shape, device, dtype) -> nn.Parameter:
    """One uninitialised inference-only parameter."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def param_dict(shapes: Dict[str, tuple], device, dtype) -> nn.ParameterDict:
    """One uninitialised parameter per ``name -> shape``, or per ``name ->
    (shape, dtype name)`` where a leaf keeps its own dtype (the MoE
    router's fp32 inside a bf16 model, Mamba2's and xLSTM's fp32 gate
    leaves)."""
    out = {}
    for name, shape in shapes.items():
        dt = dtype
        if isinstance(shape[-1], str):
            shape, dt = shape[0], _DTYPES[shape[1]]
        out[name] = param(shape, device, dt)
    return nn.ParameterDict(out)


class ZooModel(nn.Module):
    """What every family's model shares: its device (that of its
    ``final_norm``) and the check that an input lies there."""

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def _on_device(self, name: str, t) -> torch.Tensor:
        if not isinstance(t, torch.Tensor) or t.device != self.device:
            where = t.device if isinstance(t, torch.Tensor) else type(t)
            raise ValueError(f"{name} must be a tensor on the model's device "
                             f"{self.device}, got {where}")
        return t


class Block(nn.Module):
    """norm -> attention -> residual -> norm -> MLP (dense, or MoE when
    ``cfg.moe``) -> residual."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.attn = param_dict(L.attn_shapes(cfg), device, dtype)
        self.attn_norm = param(d, device, dtype)
        if cfg.moe is None:
            self.mlp = param_dict(L.mlp_shapes(cfg), device, dtype)
        else:
            self.moe = param_dict(moe_lib.moe_params_shape(cfg), device,
                                  dtype)
        self.mlp_norm = param(d, device, dtype)

    def ffn(self, h: torch.Tensor, one_group: bool = False,
            moe_impl: str = "sort", with_aux: bool = False):
        """The MLP slot on ``h [B,S,D]`` -> ``(y, aux)``. An MoE routes each
        batch row as a group with ``moe_impl``'s dispatch, or with
        ``one_group`` (decode, ``S == 1``) the whole batch as one group
        (``[B,1,D] -> [1,B,D]``). ``aux`` is the MoE's load-balancing loss
        (fp32) with ``with_aux``, else 0 (and always 0 for a dense MLP)."""
        cfg = self.cfg
        if cfg.moe is None:
            return L.mlp_apply(self.mlp, h, cfg.activation), 0.0
        if one_group:
            h = h.transpose(0, 1)
        y, aux = moe_lib.moe_apply(self.moe, h, cfg, moe_impl, with_aux)
        return (y.transpose(0, 1) if one_group else y,
                aux if with_aux else 0.0)

    def forward(self, x, positions, causal: bool, positions_3d=None,
                moe_impl: str = "sort", with_aux: bool = False):
        """The block (the reference's ``_block``) -> its output, its rotated
        ``k`` and ``v`` ``[B,S,Hkv,hd]`` (what a prefill writes to the
        cache) and ``ffn``'s ``aux``."""
        cfg = self.cfg
        h = L.rmsnorm(x, self.attn_norm, cfg.norm_eps)
        q, k, v = L.attention_qkv(self.attn, h, positions, cfg,
                                  positions_3d=positions_3d)
        x = x + L.attention_out(self.attn, q, k, v, cfg, causal,
                                cfg.attn_window)
        h = L.rmsnorm(x, self.mlp_norm, cfg.norm_eps)
        y, aux = self.ffn(h, moe_impl=moe_impl, with_aux=with_aux)
        return x + y, k, v, aux


class Transformer(ZooModel):
    """The dense, MoE or VLM-backbone model; its tensors are uninitialised
    until ``init`` fills them (on ``meta`` they are shapes only).
    ``device=None`` is the card. Its methods take ``inputs`` (token ids
    ``[B, S]``, or a vlm's embeddings ``[B, S, D]``) and lengths on the
    model's device and never move them: a tensor on another device
    raises."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = torch_dtype(cfg)
        d, v = cfg.d_model, cfg.vocab_size
        self.layers = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = param(d, device, dtype)
        self.lm_head = self.embed = None
        if not (cfg.tie_embeddings and cfg.uses_tokens):
            self.lm_head = param((d, v), device, dtype)
        if cfg.uses_tokens:
            self.embed = param((v, d), device, dtype)

    def head(self) -> torch.Tensor:
        """``[d, vocab]``: the LM head, or the embedding's transpose when
        the embeddings are tied (e.g. phi4-mini)."""
        return self.embed.T if self.lm_head is None else self.lm_head

    def _embed(self, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids -> their embeddings; a vlm's embeddings in the model's
        dtype (the reference's ``embed_inputs``)."""
        if self.cfg.uses_tokens:
            return self.embed[self._on_device("tokens", inputs).long()]
        return self._on_device("embeds", inputs).to(self.final_norm.dtype)

    def _positions(self, B: int, S: int, positions_3d=None):
        """Positions ``[B,S]`` and, for an M-RoPE config, ``positions_3d
        [3,B,S]`` (the token positions in all three streams unless
        given)."""
        positions = torch.arange(S, device=self.device).expand(B, S)
        if self.cfg.rope_type != "mrope":
            return positions, None
        if positions_3d is None:
            return positions, positions[None].expand(3, B, S)
        return positions, self._on_device("positions_3d", positions_3d)

    def hidden(self, inputs: torch.Tensor, causal: bool = True,
               positions_3d: Optional[torch.Tensor] = None,
               remat: str = "none", moe_impl: str = "sort",
               with_aux: bool = False):
        """The final-normed hidden states ``[B,S,D]`` of a full-sequence
        pass and the blocks' summed ``aux`` (``Block.ffn``); ``causal=False``
        is the encoders' bidirectional pass. Training runs every block
        under ``remat`` (``cfg.remat``, ``layers.remat``)."""
        x = self._embed(inputs)
        positions, p3 = self._positions(*x.shape[:2], positions_3d)
        aux = 0.0
        for blk in self.layers:
            x, _, _, a = L.remat(blk, remat, x, positions, causal, p3,
                                 moe_impl, with_aux)
            aux = aux + a
        return L.rmsnorm(x, self.final_norm, self.cfg.norm_eps), aux

    def forward(self, inputs: torch.Tensor,
                positions_3d: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence causal forward -> logits ``[B,S,V]``."""
        return (self.hidden(inputs, positions_3d=positions_3d)[0]
                @ self.head())

    def init_cache(self, batch: int, max_len: int) -> Dict:
        """Zeroed ``k``/``v`` ``[L, B, max_len, Hkv, hd]`` and ``pos`` 0."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=self.final_norm.dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self.final_norm.dtype,
                                 device=self.device),
                "pos": 0}

    def prefill(self, inputs: torch.Tensor, cache: Dict,
                lengths: Optional[torch.Tensor] = None,
                positions_3d: Optional[torch.Tensor] = None):
        """Run the prompt (``[B,S]`` ids, or a vlm's ``[B,S,D]``
        embeddings) through the model, writing its K/V into ``cache`` in
        place. Returns ``(last-position logits [B,V], cache)``.

        With ``lengths`` ([B] per-row real prompt lengths) the logits are
        gathered at each row's last real token and ``cache["pos"]`` becomes
        the per-row position vector; without, ``pos`` is ``S`` and the
        logits are the last position's."""
        cfg = self.cfg
        x = self._embed(inputs)
        B, S = x.shape[:2]
        positions, p3 = self._positions(B, S, positions_3d)
        for i, blk in enumerate(self.layers):
            x, k, v, _ = blk(x, positions, True, p3)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        if lengths is None:
            cache["pos"] = S
            x = x[:, -1:]
        else:
            lengths = self._on_device("lengths", lengths).long()
            cache["pos"] = lengths
            last = (lengths - 1).clamp(0, S - 1)
            x = x[torch.arange(B, device=self.device), last][:, None]
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return (x @ self.head())[:, 0], cache

    def prefill_chunk(self, tokens: torch.Tensor, cache: Dict, offset: int):
        """Chunked prefill: the ``C`` prompt tokens ``[B,C]`` at positions
        ``[offset, offset + C)`` against the cache, whose earlier chunks of
        the same sequences lie below ``offset``; their K/V are written in
        place. Returns ``(logits [B,C,V], cache)``: every position's
        logits, so the caller can take the last real token's from a
        right-padded chunk. ``cache["pos"]`` is left to the caller (the
        engine keeps per-slot positions itself)."""
        cfg = self.cfg
        x = self._embed(tokens)
        for i, blk in enumerate(self.layers):
            h = L.rmsnorm(x, blk.attn_norm, cfg.norm_eps)
            x = x + L.cached_attention_chunk(blk.attn, h, cache["k"][i],
                                             cache["v"][i], offset, cfg,
                                             window=cfg.attn_window)
            h = L.rmsnorm(x, blk.mlp_norm, cfg.norm_eps)
            x = x + blk.ffn(h)[0]
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return x @ self.head(), cache

    def decode_step(self, inputs: torch.Tensor, cache: Dict):
        """One-token decode, tokens ``[B,1]`` (a vlm's embeddings ``[B,1,
        D]``); ``cache["pos"]`` is an int (lock-step) or a ``[B]`` tensor
        (per-row positions). Writes the new K/V in place and returns
        ``(logits [B,V], cache)``."""
        cfg = self.cfg
        x = self._embed(inputs)
        B = x.shape[0]
        index = cache["pos"]
        p3 = None
        if cfg.rope_type == "mrope":   # the position in all three streams
            p3 = (index.reshape(1, B, 1) if isinstance(index, torch.Tensor)
                  else torch.full((1, B, 1), int(index),
                                  device=self.device)).expand(3, B, 1)
        for i, blk in enumerate(self.layers):
            h = L.rmsnorm(x, blk.attn_norm, cfg.norm_eps)
            x = x + L.cached_attention_step(blk.attn, h, cache["k"][i],
                                            cache["v"][i], index, cfg,
                                            window=cfg.attn_window,
                                            positions_3d=p3)
            h = L.rmsnorm(x, blk.mlp_norm, cfg.norm_eps)
            x = x + blk.ffn(h, one_group=True)[0]
        cache["pos"] = index + 1
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return (x @ self.head())[:, 0], cache


def _trunc_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF sampling), fp32."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def dense_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """Truncated-normal fan-in init of ``w [in, out]`` (std 1/sqrt(in)),
    drawn in fp32 on w's device and cast to its dtype."""
    w.copy_(_trunc_normal(w.shape, gen, w.device) / math.sqrt(w.shape[-2]))


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """A model with random weights from ``seed``, drawn by a
    ``torch.Generator`` on ``device`` itself (``None`` is the card; nothing
    is staged on the host): norms zero, the embedding N(0, 0.02), every
    matrix truncated normal with fan-in scale (the MoE's router and expert
    stacks too, one fp32 draw of a leaf at a time), as the reference's
    ``init``. The numbers differ from the reference's ``jax.random``
    draw."""
    model = Transformer(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if "norm" in name:
            p.zero_()
        elif name == "embed":
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    * 0.02)
        else:
            dense_init_(p, gen)
    return model


def _inputs(model: Transformer, batch: Dict):
    return batch["tokens"] if model.cfg.uses_tokens else batch["embeds"]


def loss_fn(model: Transformer, batch: Dict, aux_weight: float = 0.01,
            moe_impl: str = "sort") -> torch.Tensor:
    """The reference's ``loss_fn``: mean token cross entropy of the causal
    forward against ``batch["labels"]`` (positions with a label < 0
    skipped) plus ``aux_weight`` times the MoE load-balancing loss.
    ``batch`` holds ``tokens`` ``[B,S]`` (a vlm's ``embeds`` ``[B,S,D]``,
    with ``positions_3d`` optional) and ``labels``, on the model's
    device."""
    x, aux = model.hidden(_inputs(model, batch), True,
                          batch.get("positions_3d"), model.cfg.remat,
                          moe_impl, with_aux=True)
    return L.lm_loss(x, model.head(), batch["labels"]) + aux_weight * aux


def logits(model: Transformer, batch: Dict) -> torch.Tensor:
    """The full-sequence logits ``[B,S,V]`` of a batch (``loss_fn``'s
    inputs)."""
    return model(_inputs(model, batch), batch.get("positions_3d"))


Model = Transformer
