"""xLSTM (sLSTM + mLSTM blocks), arXiv:2405.04517: the port of
``repro.models.xlstm``.

The block pattern is xLSTM[7:1]: groups of ``slstm_every - 1`` mLSTM blocks
followed by one sLSTM block. No attention and no kernel: the reference
computes every cell with einsums and scans.

* mLSTM (matrix memory, exponential gating): a prefill runs the parallel
  stabilised form (quadratic in the sequence, like attention) with the
  closed-form final state, or chunkwise with the state carried across
  chunks (``cfg.mlstm_chunk``); decode the recurrent form, state ``C [nh,
  dh, dh]``, ``n [nh, dh]``, ``m [nh]``.
* sLSTM (scalar memory, block-diagonal hidden recurrence): a loop over
  time in fp32 with the stabiliser ``m``.

Training (``loss_fn``): the reference's token cross entropy of the
parallel forward from zero states, each group recomputed in the backward
unless ``cfg.remat`` is ``none``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (ZooModel, dense_init_, param,
                                            param_dict, torch_dtype)


def _dims(cfg: ModelConfig):
    """(d, mLSTM inner dim 2d, heads, mLSTM head dim)."""
    d = cfg.d_model
    di = 2 * d
    nh = cfg.n_heads
    return d, di, nh, di // nh


def _groups(cfg: ModelConfig):
    """(groups, mLSTM blocks a group)."""
    every = cfg.slstm_every or cfg.n_layers
    assert cfg.n_layers % every == 0, (cfg.n_layers, every)
    return cfg.n_layers // every, every - 1


def mlstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, di, nh, dh = _dims(cfg)
    return {"norm": (d,), "w_up": (d, 2 * di), "wq": (di, di),
            "wk": (di, di), "wv": (di, di), "w_if": (di, 2 * nh),
            "b_if": ((2 * nh,), "float32"), "out_norm": (di,),
            "w_down": (di, d)}


def slstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = sd = cfg.d_model
    nh = cfg.n_heads
    sh = sd // nh
    f = int(sd * 4 / 3 // 64 * 64) or 64    # the post-FFN's hidden width
    return {"norm": (d,), "w_in": (d, 4 * sd), "r_h": (nh, sh, 4 * sh),
            "bias": ((4 * sd,), "float32"), "out_norm": (sd,),
            "ffn_norm": (d,), "ffn_gate": (d, f), "ffn_up": (d, f),
            "ffn_down": (f, d)}


# -- mLSTM ------------------------------------------------------------------


def _mlstm_gates(x, lp):
    """(q, k, v [B,S,nh,dh], log_f, i_pre [B,S,nh] fp32) of x [B,S,di]."""
    nh = lp["b_if"].shape[-1] // 2
    di = x.shape[-1]
    dh = di // nh
    q = (x @ lp["wq"]).reshape(*x.shape[:-1], nh, dh)
    k = (x @ lp["wk"]).reshape(*x.shape[:-1], nh, dh) / math.sqrt(dh)
    v = (x @ lp["wv"]).reshape(*x.shape[:-1], nh, dh)
    pre = (x @ lp["w_if"]).float() + lp["b_if"]
    i_pre, f_pre = pre[..., :nh], pre[..., nh:]
    return q, k, v, -F.softplus(-f_pre), i_pre      # log sigmoid(f)


def _decay(cum, i_pre):
    """D[b,h,i,j] = cum_i - cum_j + i_pre_j for j <= i, -inf above."""
    S = cum.shape[1]
    D = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2) \
        + i_pre.permute(0, 2, 1)[:, :, None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=cum.device).tril()
    return D.masked_fill(~mask, float("-inf"))


def mlstm_parallel(x, lp):
    """Parallel stabilised mLSTM, x [B,S,di] -> (y [B,S,di] fp32, the
    closed-form final state)."""
    q, k, v, log_f, i_pre = _mlstm_gates(x, lp)
    B, S, nh, dh = q.shape
    cum = log_f.cumsum(1)                                  # [B,S,nh]
    D = _decay(cum, i_pre)
    m = D.amax(-1)                                         # [B,nh,S]
    Dp = torch.exp(D - m[..., None])
    scores = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * Dp
    norm = torch.maximum(scores.sum(-1).abs(), torch.exp(-m))
    y = torch.einsum("bhij,bjhd->bihd", scores.to(v.dtype).float(),
                     v.float())
    y = y / norm.transpose(1, 2)[..., None]
    # the closed-form final state
    last = cum[:, -1, None, :] - cum + i_pre               # [B,S,nh]
    m_S = torch.clamp_min(last.amax(1), 0.0)               # [B,nh]
    w = torch.exp(last - m_S[:, None, :])
    C = torch.einsum("bshd,bsh,bshe->bhde", k.float(), w, v.float())
    n = torch.einsum("bshd,bsh->bhd", k.float(), w)
    return y.reshape(B, S, nh * dh), {"C": C, "n": n, "m": m_S}


def mlstm_chunked(x, lp, chunk: int, init_state: Optional[Dict] = None):
    """Chunkwise-parallel stabilised mLSTM: a ``[c, c]`` intra-chunk block
    per chunk and the (C, n, m) state carried between chunks, the same
    function as ``mlstm_parallel`` up to summation order. x [B,S,di] ->
    (y [B,S,di] in x's dtype, the final state)."""
    q, k, v, log_f, i_pre = _mlstm_gates(x, lp)
    B, S, nh, dh = q.shape
    assert S % chunk == 0, (S, chunk)
    c = chunk
    if init_state is None:
        C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
        m = torch.full((B, nh), float("-inf"), device=x.device)
    else:
        C, n, m = init_state["C"], init_state["n"], init_state["m"]
    ys = []
    for lo in range(0, S, c):
        qc, kc, vc = q[:, lo:lo + c], k[:, lo:lo + c], v[:, lo:lo + c]
        lf, ip = log_f[:, lo:lo + c], i_pre[:, lo:lo + c]
        cum = lf.cumsum(1)                                 # [B,c,nh]
        D = _decay(cum, ip)
        m_intra = D.amax(-1)                               # [B,nh,c]
        g = (cum + m[:, None, :]).permute(0, 2, 1)         # [B,nh,c]
        m_i = torch.maximum(m_intra, g)
        Dp = torch.exp(D - m_i[..., None])
        scores = torch.einsum("bihd,bjhd->bhij", qc, kc).float() * Dp
        w_state = torch.exp(g - m_i)
        qh = qc.permute(0, 2, 1, 3).float()                # [B,nh,c,dh]
        inter_num = torch.einsum("bhcd,bhde->bhce", qh, C)
        inter_den = torch.einsum("bhcd,bhd->bhc", qh, n)
        num = torch.einsum("bhij,bjhd->bhid", scores, vc.float()) \
            + inter_num * w_state[..., None]
        den = scores.sum(-1) + inter_den * w_state
        den = torch.maximum(den.abs(), torch.exp(-m_i))
        ys.append((num / den[..., None]).transpose(1, 2).to(x.dtype))
        # the state across the whole chunk
        Fl = cum[:, -1]                                    # [B,nh]
        decay_j = Fl[:, None, :] - cum + ip                # [B,c,nh]
        m_new = torch.maximum(Fl + m, decay_j.amax(1))
        wj = torch.exp(decay_j - m_new[:, None, :])
        a = torch.exp(Fl + m - m_new)
        C = C * a[..., None, None] + torch.einsum(
            "bchd,bch,bche->bhde", kc.float(), wj, vc.float())
        n = n * a[..., None] + torch.einsum("bchd,bch->bhd", kc.float(), wj)
        m = m_new
    y = torch.cat(ys, 1).reshape(B, S, nh * dh)
    return y, {"C": C, "n": n, "m": m}


def mlstm_step(x, lp, st: Dict):
    """Recurrent mLSTM step, x [B,1,di] -> (y [B,1,di] in x's dtype, the
    new state)."""
    q, k, v, log_f, i_pre = _mlstm_gates(x, lp)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    log_f, i_pre = log_f[:, 0], i_pre[:, 0]                # [B,nh]
    m_prev, C_prev, n_prev = st["m"], st["C"], st["n"]
    m_new = torch.maximum(log_f + m_prev, i_pre)
    a = torch.exp(log_f + m_prev - m_new)[..., None]
    b = torch.exp(i_pre - m_new)[..., None]
    C = C_prev * a[..., None] + b[..., None] * k[..., :, None] * v[..., None, :]
    n = n_prev * a + b * k
    h_num = torch.einsum("bhde,bhd->bhe", C, q)
    h_den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))
    y = (h_num / h_den[..., None]).reshape(x.shape[0], 1, -1)
    return y.to(x.dtype), {"C": C, "n": n, "m": m_new}


def mlstm_block(x, lp, cfg: ModelConfig, st: Optional[Dict] = None):
    """norm -> up-projection -> cell (parallel or chunkwise over a
    sequence; with ``st`` one recurrent step) -> norm, output gate ->
    down-projection -> residual. Returns (x, the cell's new state)."""
    d, di, nh, dh = _dims(cfg)
    h = L.rmsnorm(x, lp["norm"], cfg.norm_eps)
    up = h @ lp["w_up"]
    inner, ogate = up[..., :di], up[..., di:]
    if st is not None:
        y, new = mlstm_step(inner, lp, st)
    else:
        c, S = cfg.mlstm_chunk, inner.shape[1]
        y, new = (mlstm_chunked(inner, lp, c) if c and S % c == 0 and S > c
                  else mlstm_parallel(inner, lp))
    y = L.rmsnorm(y.to(x.dtype), lp["out_norm"], cfg.norm_eps)
    y = y * F.silu(ogate)
    return x + y @ lp["w_down"], new


# -- sLSTM ------------------------------------------------------------------


def slstm_scan(x, lp, cfg: ModelConfig, st):
    """The sLSTM over time from the state ``st = (h, c, n, m)`` ([B,d]
    each, fp32), one step at a time. x [B,S,d] -> (h over time in x's
    dtype, the final state)."""
    B, S, d = x.shape
    nh = cfg.n_heads
    sh = d // nh
    pre_in = (x @ lp["w_in"]).float() + lp["bias"]         # [B,S,4d]
    r_h = lp["r_h"].float()
    h, c, n, m = st
    ys = []
    for t in range(S):
        rec = torch.einsum("bhs,hst->bht", h.reshape(B, nh, sh), r_h)
        i_pre, f_pre, z_pre, o_pre = (pre_in[:, t] + rec.reshape(B, 4 * d)
                                      ).chunk(4, dim=-1)
        log_f = -F.softplus(-f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * torch.tanh(z_pre)
        n = f_g * n + i_g
        h = torch.sigmoid(o_pre) * c / torch.clamp_min(n, 1.0)
        m = m_new
        ys.append(h)
    return torch.stack(ys, 1).to(x.dtype), (h, c, n, m)


def slstm_block(x, lp, cfg: ModelConfig, st):
    h = L.rmsnorm(x, lp["norm"], cfg.norm_eps)
    y, new = slstm_scan(h, lp, cfg, st)
    x = x + L.rmsnorm(y, lp["out_norm"], cfg.norm_eps)
    h = L.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
    h = F.silu(h @ lp["ffn_gate"]) * (h @ lp["ffn_up"])
    return x + h @ lp["ffn_down"], new


# -- the model ----------------------------------------------------------------


class XLSTM(ZooModel):
    """The xLSTM; its tensors are uninitialised until ``init`` fills them
    (on ``meta`` they are shapes only). ``mlstm[g * M + j]`` is mLSTM
    block ``j`` of group ``g`` and ``slstm[g]`` the group's sLSTM block
    (the reference's ``[G, M, ...]`` and ``[G, ...]`` leaves).
    ``device=None`` is the card; inputs must lie on the model's device."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = torch_dtype(cfg)
        G, M = _groups(cfg)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = param((v, d), device, dtype)
        self.mlstm = nn.ModuleList(param_dict(mlstm_shapes(cfg), device,
                                              dtype) for _ in range(G * M))
        self.slstm = nn.ModuleList(param_dict(slstm_shapes(cfg), device,
                                              dtype) for _ in range(G))
        self.final_norm = param(d, device, dtype)
        self.lm_head = param((d, v), device, dtype)

    def init_cache(self, batch: int, max_len: int = 0) -> Dict:
        """Zeroed recurrent states (no KV cache: ``max_len`` is unused):
        ``mlstm`` ``C [G,M,B,nh,dh,dh]``, ``n [G,M,B,nh,dh]``, ``m
        [G,M,B,nh]``; ``slstm`` ``(h, c, n, m)`` ``[G,B,d]`` each; fp32;
        ``pos`` 0."""
        cfg = self.cfg
        G, M = _groups(cfg)
        d, di, nh, dh = _dims(cfg)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        return {"mlstm": {"C": zeros(G, M, batch, nh, dh, dh),
                          "n": zeros(G, M, batch, nh, dh),
                          "m": zeros(G, M, batch, nh)},
                "slstm": tuple(zeros(G, batch, d) for _ in range(4)),
                "pos": 0}

    def _run(self, tokens, cache, step: bool, keep: bool = True):
        """Every group's mLSTM blocks and sLSTM block over the embedded
        ``tokens``, from the states in ``cache``; the new states are
        written back when ``keep``. mLSTM blocks run the parallel form (from
        a zero state, as the reference's prefill) unless ``step``."""
        cfg = self.cfg
        G, M = _groups(cfg)
        x = self.embed[self._on_device("tokens", tokens).long()]
        ms, ss = cache["mlstm"], cache["slstm"]
        for g in range(G):
            for j in range(M):
                st = ({name: t[g, j] for name, t in ms.items()} if step
                      else None)
                x, new = mlstm_block(x, self.mlstm[g * M + j], cfg, st)
                if keep:
                    for name, t in new.items():
                        ms[name][g, j] = t
            x, new = slstm_block(x, self.slstm[g], cfg,
                                 tuple(t[g] for t in ss))
            if keep:
                for t, value in zip(ss, new):
                    t[g] = value
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward from zero states -> logits ``[B,S,V]``."""
        G, M = _groups(self.cfg)
        B = tokens.shape[0]
        d = self.cfg.d_model
        zero = torch.zeros((G, B, d), dtype=torch.float32, device=self.device)
        cache = {"mlstm": {}, "slstm": (zero,) * 4}
        x = self._run(tokens, cache, step=False, keep=False)
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self.lm_head

    def prefill(self, tokens: torch.Tensor, cache: Dict):
        """The prompt ``[B,S]`` through the model: the states go into
        ``cache`` in place and ``pos`` becomes S. Returns
        ``(last-position logits [B,V], cache)``."""
        x = self._run(tokens, cache, step=False)
        cache["pos"] = tokens.shape[1]
        x = L.rmsnorm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
        return (x @ self.lm_head)[:, 0], cache

    def decode_step(self, tokens: torch.Tensor, cache: Dict):
        """One-token decode, tokens ``[B,1]``: every block's recurrent
        step. Returns ``(logits [B,V], cache)``."""
        x = self._run(tokens, cache, step=True)
        cache["pos"] = cache["pos"] + 1
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return (x @ self.lm_head)[:, 0], cache


def _train_group(model: XLSTM, x: torch.Tensor, g: int) -> torch.Tensor:
    """Group ``g``'s mLSTM blocks (parallel form) and sLSTM block from zero
    states."""
    cfg = model.cfg
    G, M = _groups(cfg)
    for j in range(M):
        x, _ = mlstm_block(x, model.mlstm[g * M + j], cfg)
    zero = torch.zeros((x.shape[0], cfg.d_model), dtype=torch.float32,
                       device=x.device)
    return slstm_block(x, model.slstm[g], cfg, (zero,) * 4)[0]


def loss_fn(model: XLSTM, batch: Dict,
            aux_weight: float = 0.0) -> torch.Tensor:
    """The reference's ``loss_fn``: mean token cross entropy of the
    forward over ``batch["tokens"]`` against ``batch["labels"]``
    (``aux_weight`` unused, as there)."""
    cfg = model.cfg
    remat = "none" if cfg.remat == "none" else "full"
    x = model.embed[model._on_device("tokens", batch["tokens"]).long()]
    for g in range(len(model.slstm)):
        x = L.remat(_train_group, remat, model, x, g)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.lm_loss(x, model.lm_head, batch["labels"])


def logits(model: XLSTM, batch: Dict) -> torch.Tensor:
    return model(batch["tokens"])


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """The cache ``init_cache`` makes, on ``meta`` (shapes only)."""
    model = XLSTM(cfg, device="meta")
    return L.cache_shapes(model.init_cache(batch, max_len))


Model = XLSTM


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, device=None) -> XLSTM:
    """A model with random weights from ``seed``, drawn by a
    ``torch.Generator`` on ``device`` (``None`` is the card), as the
    reference's ``init``: norms zero, the gate biases one (long memory at
    init), the embedding N(0, 0.02), every matrix truncated normal with
    fan-in scale. The numbers differ from the reference's ``jax.random``
    draw."""
    model = XLSTM(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if "norm" in name:
            p.zero_()
        elif name.endswith(("b_if", "bias")):
            p.fill_(1.0)
        elif name == "embed":
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    * 0.02)
        else:
            dense_init_(p, gen)
    return model
