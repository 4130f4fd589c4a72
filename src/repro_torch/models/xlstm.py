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

On a mesh the residual is sequence-parallel (the mLSTM section below);
the sLSTM's time loop runs rank-locally on batch rows, and the decode
states stay under ``cache_specs`` (``C`` sharded on its value dim).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed.sharding import constrain, is_dtensor, like
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
#
# On a mesh the residual is sequence-sharded. The row-wise parts of a block
# (norms, projections, gates) run on each rank's rows with their weights
# gathered (``layers.local_rows``); the cell's sequence mixing runs on the
# rank's query rows against the keys, values and gates gathered whole
# (``_mlstm_rows``, ``_mlstm_chunks``), the reference's layout (q
# sequence-sharded, k and v gathered). The final state (a prefill's) is
# computed whole on every rank and carries no gradient there.

_IN = ("norm", "w_up", "wq", "wk", "wv", "w_if", "b_if")
_OUT = ("out_norm", "w_down")


def _mlstm_in(x, norm, w_up, wq, wk, wv, w_if, b_if, eps: float):
    """Rows of the residual x [B,S,d] -> (q, k, v [B,S,nh,dh], log_f,
    i_pre [B,S,nh] fp32, the output gate's pre-activation [B,S,di])."""
    di = wq.shape[0]
    nh = b_if.shape[-1] // 2
    dh = di // nh
    up = L.rmsnorm(x, norm, eps) @ w_up
    inner, ogate = up[..., :di], up[..., di:]
    q = L._split_heads(inner @ wq, nh, dh)
    k = L._split_heads(inner @ wk, nh, dh) / math.sqrt(dh)
    v = L._split_heads(inner @ wv, nh, dh)
    pre = (inner @ w_if).float() + b_if
    i_pre, f_pre = pre[..., :nh], pre[..., nh:]
    return q, k, v, -F.softplus(-f_pre), i_pre, ogate    # log sigmoid(f)


def _mlstm_out(y, ogate, out_norm, w_down, eps: float):
    """Rows: the cell's output y [B,S,nh,dh] -> norm, output gate,
    down-projection [B,S,d] (in ogate's dtype)."""
    y = y.reshape(*y.shape[:2], -1).to(ogate.dtype)
    return (L.rmsnorm(y, out_norm, eps) * F.silu(ogate)) @ w_down


def _mlstm_rows(q, k, v, log_f, i_pre, r0: int = 0):
    """Parallel stabilised mLSTM for the query rows ``q [B,R,nh,dh]`` at
    positions ``r0 .. r0 + R - 1`` against every position's ``k, v`` and
    gates ``[B,S,...]`` -> y [B,R,nh,dh] fp32."""
    D = _decay(log_f.cumsum(1), i_pre, r0, q.shape[1])     # [B,nh,R,S]
    m = D.amax(-1)                                         # [B,nh,R]
    Dp = torch.exp(D - m[..., None])
    scores = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * Dp
    norm = torch.maximum(scores.sum(-1).abs(), torch.exp(-m))
    y = torch.einsum("bhij,bjhd->bihd", scores.to(v.dtype).float(),
                     v.float())
    return y / norm.transpose(1, 2)[..., None]


def _mlstm_final(k, v, log_f, i_pre):
    """The closed-form state after every position, from zero."""
    cum = log_f.cumsum(1)
    last = cum[:, -1, None, :] - cum + i_pre               # [B,S,nh]
    m_S = torch.clamp_min(last.amax(1), 0.0)               # [B,nh]
    w = torch.exp(last - m_S[:, None, :])
    C = torch.einsum("bshd,bsh,bshe->bhde", k.float(), w, v.float())
    n = torch.einsum("bshd,bsh->bhd", k.float(), w)
    return {"C": C, "n": n, "m": m_S}


def _mlstm_chunks(q, k, v, log_f, i_pre, c: int, dtype, r0: int = 0,
                  init_state: Optional[Dict] = None):
    """Chunkwise-parallel stabilised mLSTM: a ``[c, c]`` intra-chunk block
    per chunk of the query rows ``q [B,R,nh,dh]`` (positions ``r0 .. r0 + R
    - 1``, whole chunks) and the (C, n, m) state carried across every chunk
    from the first: the same function as ``_mlstm_rows`` up to summation
    order. -> (y [B,R,nh,dh] in ``dtype``, the state after position S-1)."""
    B, S, nh, dh = k.shape
    R = q.shape[1]
    if init_state is None:
        C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=k.device)
        n = torch.zeros((B, nh, dh), dtype=torch.float32, device=k.device)
        m = torch.full((B, nh), float("-inf"), device=k.device)
    else:
        C, n, m = init_state["C"], init_state["n"], init_state["m"]
    ys = []
    for lo in range(0, S, c):
        kc, vc = k[:, lo:lo + c], v[:, lo:lo + c]
        lf, ip = log_f[:, lo:lo + c], i_pre[:, lo:lo + c]
        cum = lf.cumsum(1)                                 # [B,c,nh]
        if r0 <= lo < r0 + R:      # this rank's chunk: its outputs
            qc = q[:, lo - r0:lo - r0 + c]
            D = _decay(cum, ip)
            m_intra = D.amax(-1)                           # [B,nh,c]
            g = (cum + m[:, None, :]).permute(0, 2, 1)     # [B,nh,c]
            m_i = torch.maximum(m_intra, g)
            Dp = torch.exp(D - m_i[..., None])
            scores = torch.einsum("bihd,bjhd->bhij", qc, kc).float() * Dp
            w_state = torch.exp(g - m_i)
            qh = qc.permute(0, 2, 1, 3).float()            # [B,nh,c,dh]
            inter_num = torch.einsum("bhcd,bhde->bhce", qh, C)
            inter_den = torch.einsum("bhcd,bhd->bhc", qh, n)
            num = torch.einsum("bhij,bjhd->bhid", scores, vc.float()) \
                + inter_num * w_state[..., None]
            den = scores.sum(-1) + inter_den * w_state
            den = torch.maximum(den.abs(), torch.exp(-m_i))
            ys.append((num / den[..., None]).transpose(1, 2).to(dtype))
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
    return torch.cat(ys, 1), {"C": C, "n": n, "m": m}


def _decay(cum, i_pre, r0: int = 0, R: Optional[int] = None):
    """D[b,h,i,j] = cum_i - cum_j + i_pre_j for j <= i, -inf above, for
    the rows i = r0 .. r0 + R - 1 (all of them by default) and every
    column j: ``[B, nh, R, S]``."""
    S = cum.shape[1]
    R = S if R is None else R
    D = (cum[:, r0:r0 + R, None, :] - cum[:, None, :, :]).permute(
        0, 3, 1, 2) + i_pre.permute(0, 2, 1)[:, :, None, :]
    rows = torch.arange(r0, r0 + R, device=cum.device)
    mask = torch.arange(S, device=cum.device)[None, :] <= rows[:, None]
    return D.masked_fill(~mask, float("-inf"))


def _mlstm_seq(q, k, v, log_f, i_pre, cfg: ModelConfig, dtype):
    """The cell over a sequence from a zero state: chunkwise
    (``cfg.mlstm_chunk``) or parallel -> (y [B,S,nh,dh], the final state).
    On DTensors each rank computes its query rows (whole chunks; the
    chunks' state recurrence from the first chunk) against the gathered
    keys, values and gates."""
    c, S = cfg.mlstm_chunk, q.shape[1]
    chunked = bool(c) and S % c == 0 and S > c
    if not is_dtensor(q):
        if chunked:
            return _mlstm_chunks(q, k, v, log_f, i_pre, c, dtype)
        return _mlstm_rows(q, k, v, log_f, i_pre), \
            _mlstm_final(k, v, log_f, i_pre)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    qpl = list(q.placements)
    r0, R = L.row_span(q)
    if chunked and (r0 % c or R % c):
        q = L._to(q, L.rows_placement(q))        # whole chunks a rank
        qpl, (r0, R) = list(q.placements), (0, S)
    full = L.rows_placement(q)
    # each rank's query rows read every key: its gradients of the gathered
    # inputs are a partial sum over the ranks that split the rows
    grad = [Partial() if p == Shard(1) else f for p, f in zip(qpl, full)]
    ins = [L._to(t, full) for t in (k, v, log_f, i_pre)]
    mesh = q.device_mesh

    def rows(ql, kl, vl, fl, il):
        if chunked:
            return _mlstm_chunks(ql, kl, vl, fl, il, c, dtype, r0)[0]
        return _mlstm_rows(ql, kl, vl, fl, il, r0)

    y = local_map(rows, out_placements=qpl, in_placements=(qpl,) + (
        full,) * 4, in_grad_placements=(qpl,) + (grad,) * 4,
        device_mesh=mesh)(q, *ins)
    def final(*t):
        st = (_mlstm_chunks(t[0], *t, c, dtype)[1] if chunked
              else _mlstm_final(*t))
        return st["C"], st["n"], st["m"]

    with torch.no_grad():
        C, n, m = local_map(final, out_placements=(full,) * 3,
                            in_placements=(full,) * 4, device_mesh=mesh)(
            *(t.detach() for t in ins))
    return y, {"C": C, "n": n, "m": m}


def mlstm_step(q, k, v, log_f, i_pre, st: Dict):
    """Recurrent mLSTM step on one position's ``q, k, v [B,nh,dh]`` and
    gates ``[B,nh]`` from the state ``st`` -> (h_num [B,nh,dh], h_den
    [B,nh], the new state), fp32."""
    q, k, v = q.float(), k.float(), v.float()
    m_prev, C_prev, n_prev = st["m"], st["C"], st["n"]
    m_new = torch.maximum(log_f + m_prev, i_pre)
    a = torch.exp(log_f + m_prev - m_new)[..., None]
    b = torch.exp(i_pre - m_new)[..., None]
    C = C_prev * a[..., None] + b[..., None] * k[..., :, None] * v[..., None, :]
    n = n_prev * a + b * k
    h_num = torch.einsum("bhde,bhd->bhe", C, q)
    h_den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))
    return h_num, h_den, {"C": C, "n": n, "m": m_new}


def _mlstm_step(q, k, v, log_f, i_pre, st: Dict):
    """``mlstm_step`` on one position ([B,1,...] inputs) -> (y [B,1,nh,dh]
    fp32, the new state). On DTensors the matrix state ``C`` keeps its
    cache shards where they split its value dim (``partition.cache_specs``
    puts "model" there: the product with q contracts the key dim, so it
    stays local), ``v`` is taken at C's block, and ``n``, ``m`` and the
    other inputs are gathered (small); the output is gathered after."""
    args = [t[:, 0] for t in (q, k, v, log_f, i_pre)]
    if not is_dtensor(q):
        h_num, h_den, new = mlstm_step(*args, st)
        return (h_num / h_den[..., None])[:, None], new
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    C = st["C"]
    cpl = [p if p in (Shard(0), Shard(3)) else Replicate()
           for p in C.placements]
    C = L._to(C, cpl)
    full = L.rows_placement(C)
    ypl = [Shard(2) if p == Shard(3) else p for p in cpl]
    dv = L.local_block(C)[3]

    def step(ql, kl, vl, fl, il, Cl, nl, ml):
        h_num, h_den, new = mlstm_step(ql, kl, vl[..., dv], fl, il,
                                       {"C": Cl, "n": nl, "m": ml})
        return h_num / h_den[..., None], new["C"], new["n"], new["m"]

    y, C, n, m = local_map(
        step, out_placements=(ypl, cpl, full, full),
        in_placements=(full,) * 5 + (cpl, full, full), device_mesh=C.device_mesh)(
        *(L._to(t, full) for t in args), C, L._to(st["n"], full),
        L._to(st["m"], full))
    return L._to(y, full)[:, None], {"C": C, "n": n, "m": m}


def mlstm_block(x, lp, cfg: ModelConfig, st: Optional[Dict] = None):
    """norm -> up-projection -> cell (parallel or chunkwise over a
    sequence; with ``st`` one recurrent step) -> norm, output gate ->
    down-projection -> residual. Returns (x, the cell's new state)."""
    eps = cfg.norm_eps
    q, k, v, log_f, i_pre, ogate = L.local_rows(
        lambda h, *w: _mlstm_in(h, *w, eps), [x], [lp[n] for n in _IN],
        n_out=6)
    if st is not None:
        y, new = _mlstm_step(q, k, v, log_f, i_pre, st)
    else:
        y, new = _mlstm_seq(q, k, v, log_f, i_pre, cfg, x.dtype)
    y = L.local_rows(lambda yl, og, *w: _mlstm_out(yl, og, *w, eps),
                     [y, ogate], [lp[n] for n in _OUT])
    return x + y, new


# -- sLSTM ------------------------------------------------------------------


def slstm_scan(pre_in, r_h, st):
    """The sLSTM over time from the state ``st = (h, c, n, m)`` ([B,d]
    each, fp32), one step at a time: pre_in [B,S,4d] fp32 (the input
    projection), r_h [nh, sh, 4sh] -> (h over time [B,S,d] fp32, the final
    state)."""
    if pre_in.device.type == "meta":
        return _slstm_scan_meta(pre_in, r_h, st)
    B, S = pre_in.shape[:2]
    nh, sh = r_h.shape[:2]
    d = nh * sh
    r_h = r_h.float()
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
    return torch.stack(ys, 1), (h, c, n, m)


def _slstm_scan_meta(pre_in, r_h, st):
    """``slstm_scan`` on ``meta`` tensors (shapes only: the dry-run and the
    roofline's counts): every step's operations at once on S times the
    rows, each step's previous state an uninitialised tensor (its values
    do not exist on ``meta``), so the counted FLOPs and bytes are the
    loop's without dispatching its S steps one at a time."""
    B, S = pre_in.shape[:2]
    nh, sh = r_h.shape[:2]
    d = nh * sh
    h, c, n, m = (pre_in.new_empty((B, S, d)) for _ in range(4))
    rec = torch.einsum("bjhs,hst->bjht", h.reshape(B, S, nh, sh),
                       r_h.float())
    i_pre, f_pre, z_pre, o_pre = (pre_in + rec.reshape(B, S, 4 * d)
                                  ).chunk(4, dim=-1)
    log_f = -F.softplus(-f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_pre)
    n = f_g * n + i_g
    h = torch.sigmoid(o_pre) * c / torch.clamp_min(n, 1.0)
    return h.clone(), tuple(t[:, -1] for t in (h, c, n, m_new))


def _slstm_in(x, norm, w_in, bias, eps: float):
    return (L.rmsnorm(x, norm, eps) @ w_in).float() + bias


def _slstm_out(x, y, out_norm, ffn_norm, ffn_gate, ffn_up, ffn_down,
               eps: float):
    x = x + L.rmsnorm(y.to(x.dtype), out_norm, eps)
    h = L.rmsnorm(x, ffn_norm, eps)
    h = F.silu(h @ ffn_gate) * (h @ ffn_up)
    return x + h @ ffn_down


def slstm_block(x, lp, cfg: ModelConfig, st):
    """The sLSTM block from the state ``st``. On DTensors its input
    projection and its FFN run on each rank's rows (``local_rows``); the
    time loop runs rank-locally on the batch rows (``pre_in`` gathered
    over the sequence, sharded on the batch only; the sLSTM's parameters
    are replicated), one whole loop a rank, as the reference places it."""
    eps = cfg.norm_eps
    pre_in = L.local_rows(lambda h, *w: _slstm_in(h, *w, eps), [x],
                          [lp["norm"], lp["w_in"], lp["bias"]])
    if is_dtensor(pre_in):
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        mesh = pre_in.device_mesh
        full = L.rows_placement(pre_in)
        rep = [Replicate()] * mesh.ndim
        st = tuple(L._to(like(t, pre_in), full) for t in st)
        # r_h's gradient from this rank's rows: a partial sum over the
        # data ranks
        summed = [Partial() if f == Shard(0) else r
                  for f, r in zip(full, rep)]
        y, *new = local_map(
            lambda p, r, *s: (lambda y, s: (y, *s))(*slstm_scan(p, r, s)),
            out_placements=(full,) * 5, in_placements=(full, rep) + (
                full,) * 4, in_grad_placements=(full, summed) + (full,) * 4,
            device_mesh=mesh)(
            L._to(pre_in, full), L._to(lp["r_h"], rep), *st)
    else:
        y, new = slstm_scan(pre_in, lp["r_h"], st)
    out = L.local_rows(lambda xl, yl, *w: _slstm_out(xl, yl, *w, eps),
                       [x, y], [lp[n] for n in ("out_norm", "ffn_norm",
                                                "ffn_gate", "ffn_up",
                                                "ffn_down")])
    return out, new


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

    def _embed(self, tokens):
        """Token ids -> the residual (sequence-parallel on a mesh)."""
        return constrain(L.embed_tokens(self.embed, self._on_device(
            "tokens", tokens)), "batch", "seq", "embed")

    def _run(self, tokens, cache, step: bool, keep: bool = True):
        """Every group's mLSTM blocks and sLSTM block over the embedded
        ``tokens``, from the states in ``cache``; the new states are
        written back when ``keep``. mLSTM blocks run the parallel form (from
        a zero state, as the reference's prefill) unless ``step``."""
        cfg = self.cfg
        G, M = _groups(cfg)
        x = self._embed(tokens)
        ms, ss = cache["mlstm"], cache["slstm"]
        for g in range(G):
            for j in range(M):
                st = ({name: t[g, j] for name, t in ms.items()} if step
                      else None)
                x, new = mlstm_block(x, self.mlstm[g * M + j], cfg, st)
                x = constrain(x, "batch", "seq", "embed")
                if keep:
                    for name, t in new.items():
                        L.assign(ms[name], (g, j), t)
            x, new = slstm_block(x, self.slstm[g], cfg,
                                 tuple(t[g] for t in ss))
            x = constrain(x, "batch", "seq", "embed")
            if keep:
                for t, value in zip(ss, new):
                    L.assign(t, (g,), value)
        return x

    def _head(self, x):
        x = constrain(L.rmsnorm(x, self.final_norm, self.cfg.norm_eps),
                      "batch", None, "embed")
        return constrain(x @ self.lm_head, "batch", None, "vocab")

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward from zero states -> logits ``[B,S,V]``."""
        G, M = _groups(self.cfg)
        B = tokens.shape[0]
        d = self.cfg.d_model
        zero = torch.zeros((G, B, d), dtype=torch.float32, device=self.device)
        cache = {"mlstm": {}, "slstm": (zero,) * 4}
        return self._head(self._run(tokens, cache, step=False, keep=False))

    def prefill(self, tokens: torch.Tensor, cache: Dict):
        """The prompt ``[B,S]`` through the model: the states go into
        ``cache`` in place and ``pos`` becomes S. Returns
        ``(last-position logits [B,V], cache)``."""
        x = self._run(tokens, cache, step=False)
        cache["pos"] = tokens.shape[1]
        return self._head(x[:, -1:])[:, 0], cache

    def decode_step(self, tokens: torch.Tensor, cache: Dict):
        """One-token decode, tokens ``[B,1]``: every block's recurrent
        step. Returns ``(logits [B,V], cache)``."""
        x = self._run(tokens, cache, step=True)
        cache["pos"] = cache["pos"] + 1
        return self._head(x)[:, 0], cache


def _train_group(model: XLSTM, x: torch.Tensor, g: int) -> torch.Tensor:
    """Group ``g``'s mLSTM blocks (parallel form) and sLSTM block from zero
    states."""
    cfg = model.cfg
    G, M = _groups(cfg)
    for j in range(M):
        x = constrain(mlstm_block(x, model.mlstm[g * M + j], cfg)[0],
                      "batch", "seq", "embed")
    zero = torch.zeros((x.shape[0], cfg.d_model), dtype=torch.float32,
                       device=x.device)
    return constrain(slstm_block(x, model.slstm[g], cfg, (zero,) * 4)[0],
                     "batch", "seq", "embed")


def loss_fn(model: XLSTM, batch: Dict,
            aux_weight: float = 0.0) -> torch.Tensor:
    """The reference's ``loss_fn``: mean token cross entropy of the
    forward over ``batch["tokens"]`` against ``batch["labels"]``
    (``aux_weight`` unused, as there)."""
    cfg = model.cfg
    remat = "none" if cfg.remat == "none" else "full"
    x = model._embed(batch["tokens"])
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
