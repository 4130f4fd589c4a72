"""Mamba2 (SSD, state-space duality) block, arXiv:2405.21060: the port of
``repro.models.mamba2``.

A prefill runs the chunked SSD algorithm: the intra-chunk terms are dense
einsums, the inter-chunk recurrence a loop over the chunks (the reference's
``lax.scan``). Decode is the O(1) recurrent update of the state ``[b, nh,
P, N]``. These are large products outside any Pallas kernel in the
reference, so they stay ``torch.einsum``. Parameters are one
``ParameterDict`` a layer with the reference's leaf names and layouts.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, like
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def mamba_dims(cfg: ModelConfig):
    """(d, d_inner, head dim P, heads, state N, groups, conv channels)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    P = 64
    nh = di // P
    N = cfg.ssm_state
    g = cfg.ssm_groups
    return d, di, P, nh, N, g, di + 2 * g * N


def params_shape(cfg: ModelConfig) -> Dict[str, tuple]:
    """One layer's leaves ``name -> shape`` (``(shape, "float32")`` for the
    fp32 leaves), as the reference's ``params_shape``."""
    d, di, P, nh, N, g, conv_ch = mamba_dims(cfg)
    return {
        "norm": (d,),
        "in_proj": (d, 2 * di + 2 * g * N + nh),
        "conv_w": (cfg.conv_width, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": ((nh,), "float32"),
        "D": ((nh,), "float32"),
        "dt_bias": ((nh,), "float32"),
        "gate_norm": (di,),
        "out_proj": (di, d),
    }


def init_(params, gen: torch.Generator, dense_init_) -> None:
    """The reference's init of one layer: norms and the conv bias zero,
    ``A_log = log(linspace(1, 16, nh))``, ``D`` one, ``dt_bias`` -2, the
    matrices and the conv weight truncated normal with fan-in scale."""
    for name, p in params.items():
        if "norm" in name or name == "conv_b":
            p.zero_()
        elif name == "A_log":
            p.copy_(torch.linspace(1.0, 16.0, p.shape[-1]).log())
        elif name == "D":
            p.fill_(1.0)
        elif name == "dt_bias":
            p.fill_(-2.0)
        else:
            dense_init_(p, gen)


def state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    """A zeroed recurrent state: ``ssm [b, nh, P, N]`` fp32 and ``conv
    [b, conv_width - 1, conv_ch]`` in the model's dtype."""
    d, di, P, nh, N, g, conv_ch = mamba_dims(cfg)
    return {"ssm": torch.zeros((batch, nh, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}


def _project(x, norm, in_proj, di: int, conv_ch: int, eps: float):
    """Rows: the norm and the input projection -> (z, xbc, dt_pre)."""
    zxbcdt = L.rmsnorm(x, norm, eps) @ in_proj
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_ch],
            zxbcdt[..., di + conv_ch:])


def _causal_conv(xbc, conv_w, conv_b, prev):
    """Depthwise causal conv over ``xbc [B,S,C]`` after the history ``prev
    [B,W-1,C]``; returns (silu(out), the new history)."""
    W = conv_w.shape[0]
    S = xbc.shape[1]
    xpad = torch.cat([prev.to(xbc.dtype), xbc], dim=1)
    out = 0
    for i in range(W):
        out = out + xpad[:, i:i + S, :] * conv_w[i][None, None]
    out = out + conv_b[None, None]
    return F.silu(out), xpad[:, xpad.shape[1] - (W - 1):, :]


def _split_xbc(xbc, cfg: ModelConfig):
    d, di, P, nh, N, g, conv_ch = mamba_dims(cfg)
    xs = xbc[..., :di].reshape(*xbc.shape[:-1], nh, P)
    B = xbc[..., di:di + g * N].reshape(*xbc.shape[:-1], g, N)
    C = xbc[..., di + g * N:].reshape(*xbc.shape[:-1], g, N)
    return xs, B, C


def _segsum(a):
    """a: [..., T] -> [..., T, T], out[i, j] = sum_{k=j+1..i} a_k for
    j <= i, -inf above the diagonal."""
    T = a.shape[-1]
    cs = a.cumsum(-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(xs, dt, A, B, C, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                chunks: Optional[slice] = None):
    """Chunked SSD. xs [b,S,nh,P]; dt [b,S,nh] (after softplus); A [nh]
    (negative); B, C [b,S,g,N] with g == 1 (broadcast over heads). Returns
    (y [b,S,nh,P] fp32, final state [b,nh,P,N] fp32); with ``chunks``
    (a slice of chunk indices) y of those chunks' positions alone: the
    inter-chunk recurrence still runs over every chunk."""
    b, S, nh, P = xs.shape
    N = B.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    sel = chunks or slice(0, nc)
    a = (dt * A[None, None, :]).float()                   # log decay
    xdt = (xs * dt[..., None]).float()

    def csplit(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    a_c, xdt_c = csplit(a), csplit(xdt)
    B_c = csplit(B.float())[..., 0, :]                    # [b,nc,cl,N]
    C_c = csplit(C.float())[..., 0, :]
    # chunk-final states: S_c = sum_j decay(last, j) B_j (x) xdt_j
    cum = a_c.cumsum(2)                                   # [b,nc,cl,nh]
    dec_last = torch.exp(cum[:, :, -1:, :] - cum)
    S_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn", dec_last, B_c, xdt_c)
    # the inter-chunk recurrence, one chunk at a time
    a_tot = cum[:, :, -1, :]                              # [b,nc,nh]
    h = (torch.zeros((b, nh, P, N), dtype=torch.float32, device=xs.device)
         if init_state is None else init_state.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(a_tot[:, c])[:, :, None, None] + S_chunk[:, c]
    h_prev = torch.stack(h_prev[sel], 1)                  # [b,n,nh,P,N]
    a_c, xdt_c, B_c, C_c, cum = (t[:, sel] for t in (a_c, xdt_c, B_c, C_c,
                                                     cum))
    Ldec = torch.exp(_segsum(a_c.permute(0, 1, 3, 2)))    # [b,n,nh,cl,cl]
    # intra-chunk: y_diag[i] = sum_{j<=i} (C_i.B_j) decay(i,j) xdt_j
    CB = torch.einsum("bcin,bcjn->bcij", C_c, B_c)
    M = CB[:, :, None] * Ldec
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xdt_c)
    # off-chunk part: y_off[i] = decay(i, chunk start) C_i . h_prev
    y_off = torch.einsum("bcin,bcih,bchpn->bcihp", C_c, torch.exp(cum),
                         h_prev)
    return (y_diag + y_off).reshape(b, -1, nh, P), h


def ssd_step(x, dt, A, B, C, ssm):
    """Recurrent SSD step. x [b,nh,P], dt [b,nh], B, C [b,N] (g == 1),
    ssm [b,nh,P,N]; returns (y [b,nh,P], the new state), fp32."""
    a = torch.exp((dt * A[None]).float())
    xdt = (x * dt[..., None]).float()
    new = ssm * a[..., None, None] + torch.einsum("bhp,bn->bhpn", xdt,
                                                  B.float())
    return torch.einsum("bhpn,bn->bhp", new, C.float()), new


_CORE = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _mix(xbc, dt_pre, conv_w, conv_b, dt_bias, A_log, D, prev, cfg,
         chunk: int, r0: int = 0, R: Optional[int] = None):
    """The block's sequence mixing over every position of ``xbc [B,S,C]``
    and ``dt_pre [B,S,nh]`` after the conv history ``prev``: the causal
    conv, the chunked SSD and the skip, for positions ``r0 .. r0 + R - 1``
    -> (y [B,R,di] fp32, final SSM state, conv history)."""
    di = mamba_dims(cfg)[1]
    S = xbc.shape[1]
    R = S if R is None else R
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, prev)
    xs, Bc, Cc = _split_xbc(xbc, cfg)
    dt = F.softplus(dt_pre.float() + dt_bias)
    aligned = r0 % chunk == 0 and R % chunk == 0
    sel = slice(r0 // chunk, (r0 + R) // chunk) if aligned else None
    y, hN = ssd_chunked(xs, dt, -torch.exp(A_log), Bc, Cc, chunk,
                        chunks=sel)
    if not aligned:
        y = y[:, r0:r0 + R]
    y = y + xs[:, r0:r0 + R].float() * D[None, None, :, None]
    return y.reshape(*y.shape[:2], di), hN, new_conv


def block_forward(x, lp, cfg: ModelConfig, chunk: Optional[int] = None):
    """Full-sequence Mamba2 block from a zero state, x [B,S,d]. Returns
    (x + the block's output, {"ssm": final state, "conv": history}).

    On a mesh the residual is sequence-sharded: the norm and the
    projections run on each rank's rows (``layers.local_rows``, weights
    gathered at use); the conv and the SSD read every position (xbc and dt
    gathered) and each rank computes its own rows' outputs, the chunks'
    state recurrence running over every chunk before them (the final state
    is computed whole on every rank and carries no gradient there)."""
    d, di, P, nh, N, g, conv_ch = mamba_dims(cfg)
    B_, S = x.shape[:2]
    eps = cfg.norm_eps
    z, xbc, dt_pre = L.local_rows(
        lambda h, *w: _project(h, *w, di, conv_ch, eps), [x],
        [lp["norm"], lp["in_proj"]], n_out=3)
    chunk = chunk or min(cfg.ssm_chunk, S)
    prev = torch.zeros((B_, cfg.conv_width - 1, conv_ch), dtype=x.dtype,
                       device=x.device)
    core = [lp[n] for n in _CORE]
    if is_dtensor(x):
        y, hN, new_conv = _mix_sharded(xbc, dt_pre, core, prev, cfg, chunk)
    else:
        y, hN, new_conv = _mix(xbc, dt_pre, *core, prev, cfg, chunk)
    out = L.local_rows(lambda yl, zl, gn, w: L.rmsnorm(
        (yl.to(zl.dtype) * F.silu(zl)), gn, eps) @ w, [y, z],
        [lp["gate_norm"], lp["out_proj"]])
    return x + out, {"ssm": hN, "conv": new_conv}


def _mix_sharded(xbc, dt_pre, core, prev, cfg, chunk: int):
    """``_mix`` on DTensors: each rank's rows of the output against the
    gathered inputs (their gradients a partial sum over the ranks that
    split the rows, as the replicated core parameters' are)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xbc.device_mesh
    rows = list(xbc.placements)
    r0, R = L.row_span(xbc)
    full = L.rows_placement(xbc)
    rep = [Replicate()] * mesh.ndim
    part = [Partial() if p == Shard(1) else f for p, f in zip(rows, full)]
    summed = [Partial() if isinstance(p, Shard) else Replicate()
              for p in rows]
    ins = [L._to(t, full) for t in (xbc, dt_pre)]
    ws = [L._to(w, rep) for w in core]
    y = local_map(
        lambda *a: _mix(*a, cfg, chunk, r0, R)[0], out_placements=rows,
        in_placements=(full, full) + (rep,) * len(ws) + (full,),
        in_grad_placements=(part, part) + (summed,) * len(ws) + (full,),
        device_mesh=mesh)(*ins, *ws, L._to(like(prev, xbc), full))
    with torch.no_grad():
        _, hN, new_conv = local_map(
            lambda *a: _mix(*a, cfg, chunk), out_placements=(full,) * 3,
            in_placements=(full, full) + (rep,) * len(ws) + (full,),
            device_mesh=mesh)(*(t.detach() for t in ins),
                              *(w.detach() for w in ws),
                              L._to(like(prev, xbc), full))
    return y, hN, new_conv


def _step_core(xbc, dt_pre, conv_w, conv_b, dt_bias, A_log, D, conv, ssm,
               cfg, blk=None):
    """One position's conv and SSD step from the states (``ssm`` this
    rank's block ``blk`` of heads and head dims when given) -> (y
    [B,nh',P'] fp32, the new ssm block, the new conv history)."""
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv)
    xs, Bc, Cc = _split_xbc(xbc, cfg)
    dt = F.softplus(dt_pre.float() + dt_bias)
    A = -torch.exp(A_log)
    x0, dt0, Dv = xs[:, 0], dt[:, 0], D
    if blk is not None:
        h, p = blk[1], blk[2]
        x0, dt0, A, Dv = x0[:, h][:, :, p], dt0[:, h], A[h], D[h]
    y, new_ssm = ssd_step(x0, dt0, A, Bc[:, 0, 0], Cc[:, 0, 0], ssm)
    return y + x0.float() * Dv[None, :, None], new_ssm, new_conv


def block_step(x, lp, cfg: ModelConfig, st: Dict):
    """Single-token Mamba2 block, x [B,1,d], from the state ``st``.
    Returns (x + the block's output, the new state). On a mesh the SSM
    state keeps its cache shards where they split heads or head dims (the
    step is local to them), the conv history and the step's inputs are
    gathered (small)."""
    d, di, P, nh, N, g, conv_ch = mamba_dims(cfg)
    B_ = x.shape[0]
    eps = cfg.norm_eps
    z, xbc, dt_pre = L.local_rows(
        lambda h, *w: _project(h, *w, di, conv_ch, eps), [x],
        [lp["norm"], lp["in_proj"]], n_out=3)
    core = [lp[n] for n in _CORE]
    if is_dtensor(x):
        y, new_ssm, new_conv = _step_sharded(xbc, dt_pre, core, st, cfg)
    else:
        y, new_ssm, new_conv = _step_core(xbc, dt_pre, *core, st["conv"],
                                          st["ssm"], cfg)
    y = y.reshape(B_, 1, di)
    out = L.local_rows(lambda yl, zl, gn, w: L.rmsnorm(
        (yl.to(zl.dtype) * F.silu(zl)), gn, eps) @ w, [y, z],
        [lp["gate_norm"], lp["out_proj"]])
    return x + out, {"ssm": new_ssm, "conv": new_conv}


def _step_sharded(xbc, dt_pre, core, st, cfg):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ssm = st["ssm"]
    mesh = ssm.device_mesh
    spl = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
           for p in ssm.placements]
    ssm = L._to(ssm, spl)
    full = L.rows_placement(ssm)
    rep = [Replicate()] * mesh.ndim
    blk = L.local_block(ssm)
    ws = [L._to(w, rep) for w in core]
    y, new_ssm, new_conv = local_map(
        lambda *a: _step_core(*a, cfg, blk), out_placements=(spl, spl, full),
        in_placements=(full, full) + (rep,) * len(ws) + (full, spl),
        device_mesh=mesh)(L._to(xbc, full), L._to(dt_pre, full), *ws,
                          L._to(st["conv"], full), ssm)
    return L._to(y, full), new_ssm, new_conv
