"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function computes on any device, with ordinary tensor ops, what its
hand-written kernel computes. The CPU tests hold them against the JAX
package; on the card they are the reference the kernels are held against.

Tie order follows ``lax.top_k``: among equal scores the lower position
comes first, so every top-k here is a stable descending sort cut to ``k``
(``torch.topk`` leaves the order of ties unspecified on CUDA).
"""
from __future__ import annotations

import math

import torch

NEG = -3.0e38
ROW_ALIGN = 4   # the list kernels read rows in 16-byte units: d % 4 == 0


def padded_width(d: int) -> int:
    """``d`` rounded up to ``ROW_ALIGN``."""
    return -(-d // ROW_ALIGN) * ROW_ALIGN


def pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t [..., d]`` with zero columns up to ``[..., width]``: a copy, or
    ``t`` itself when ``d == width``. A zero column changes no inner
    product, so the padded search is the same search."""
    d = t.shape[-1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


def stable_topk(scores: torch.Tensor, k: int):
    """Top-``k`` along dim 1 in ``lax.top_k`` order; pads with
    ``(NEG, position)`` when the row is shorter than ``k``."""
    n = scores.shape[1]
    if n < k:
        pad = scores.new_full((scores.shape[0], k - n), NEG)
        scores = torch.cat([scores, pad], dim=1)
    top, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k], pos[:, :k]


def _sentinel(top: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Ids whose score is at or below ``NEG/2`` (dead or padding) -> -1."""
    return torch.where(top <= NEG / 2, torch.full_like(idx, -1), idx)


def masked_topk(scores, live, k: int):
    """Top-``k`` of ``scores [nq, N]`` over the ``live [N]`` columns, as
    ``(scores [nq,k] f32, idx [nq,k] int32)`` with ``(NEG, -1)`` padding."""
    scores = torch.where(live.bool()[None, :], scores,
                         torch.tensor(NEG, dtype=scores.dtype,
                                      device=scores.device))
    top, idx = stable_topk(scores, k)
    return top, _sentinel(top, idx.int())


def topk_search(q, vecs, live, k: int):
    """Exact inner-product top-k. q:[nq,d] vecs:[N,d] f32, live:[N] bool.

    Returns ``(scores [nq,k] f32, idx [nq,k] int32)``; rows with fewer than
    ``k`` live entries pad with ``(NEG, -1)``.
    """
    return masked_topk(q @ vecs.T, live, k)


def quant_score(q, codes, scale):
    """SQ-int8 scores ``[nq, N]`` f32: ``(q * scale) @ codes.T`` with the
    int8 ``codes [N, d]`` upcast to f32. No live mask: every row is scored.
    """
    return (q * scale[None, :]) @ codes.float().T


def sq8_topk(q, codes, scale, live, k: int):
    """SQ-int8 exact top-k: the top-``k`` of ``quant_score`` over the live
    rows, with ``(NEG, -1)`` padding (the contract of ``topk_search``)."""
    return masked_topk(quant_score(q, codes, scale), live, k)


def merge_candidates(cand_s, cand_i, k: int):
    """Global top-k over per-tile / per-bucket candidates ``[nq, C]`` laid
    out tile-major, rank-minor (so ties resolve as a top-k over the whole
    score matrix would). Pads with ``(NEG, -1)`` when ``C < k``."""
    top, pos = stable_topk(cand_s, k)
    c = cand_i.shape[1]
    if c < k:
        cand_i = torch.cat([cand_i, cand_i.new_full(
            (cand_i.shape[0], k - c), -1)], dim=1)
    return top, _sentinel(top, torch.gather(cand_i, 1, pos))


def probe(q, cent, nprobe: int):
    """Centroid scores -> the top-``nprobe`` bucket ids ``[nq, nprobe]``
    int32 (the same arithmetic as the unfused IVF search's probe)."""
    return stable_topk(q @ cent.T, nprobe)[1].int()


def ivf_topk(q, cent, packed_vecs, packed_slot, packed_ok, nprobe: int,
             k: int):
    """IVF probe -> bucket score -> select over the packed mirror.

    q:[nq,d]; cent:[nlist,d]; packed_vecs:[nlist*cap_b,d];
    packed_slot/packed_ok:[nlist*cap_b] (slot id / liveness of each packed
    row). Each probed bucket yields its own top-k as slot ids; the
    ``[nq, nprobe*k]`` candidates merge probe-major.
    """
    nq, d = q.shape
    nlist = cent.shape[0]
    cap_b = packed_vecs.shape[0] // nlist
    probes = probe(q, cent, nprobe).long()
    pv = packed_vecs.view(nlist, cap_b, d)
    ps = packed_slot.view(nlist, cap_b)
    po = packed_ok.view(nlist, cap_b).bool()
    kt = min(k, cap_b)
    neg = torch.tensor(NEG, dtype=q.dtype, device=q.device)
    cs, ci = [], []
    for p in range(nprobe):
        b = probes[:, p]
        s = torch.bmm(pv[b], q[:, :, None])[:, :, 0]      # [nq, cap_b]
        ts, tp = stable_topk(torch.where(po[b], s, neg), kt)
        cs.append(ts)
        ci.append(torch.gather(ps[b], 1, tp))
    return merge_candidates(torch.stack(cs, 1).reshape(nq, nprobe * kt),
                            torch.stack(ci, 1).reshape(nq, nprobe * kt), k)


def pq_lut(q, codebook):
    """Per-query ADC lookup tables ``[nq, m, 256]``: each query subspace
    against its codebook ``[m, 256, dsub]``."""
    m, _, dsub = codebook.shape
    return torch.einsum("qms,mcs->qmc", q.reshape(q.shape[0], m, dsub),
                        codebook)


def adc_sum(gath):
    """Sum over the trailing subspace axis in order ``t = 0 .. m-1`` with
    plain adds, so rows with equal codes score bit-identically, here and
    in the ``pq_topk`` kernel."""
    out = gath[..., 0]
    for t in range(1, gath.shape[-1]):
        out = out + gath[..., t]
    return out


def pq_topk(q, codebook, cent, packed_codes, packed_slot, packed_ok,
            nprobe: int, k: int):
    """PQ-ADC probe -> LUT score -> select over the packed bucket codes.

    q:[nq,d]; codebook:[m,256,dsub]; cent:[nlist,d];
    packed_codes:[nlist*cap_b, m] uint8, or int32 in [0, 256) as the
    reference keeps them (the same result);
    packed_slot/packed_ok:[nlist*cap_b]. A row scores
    ``adc_sum(LUT[t, code_t])``; each probed bucket yields its own top-k as
    slot ids and the ``[nq, nprobe*k]`` candidates merge probe-major.
    """
    nq = q.shape[0]
    m = codebook.shape[0]
    nlist = cent.shape[0]
    cap_b = packed_codes.shape[0] // nlist
    flat_lut = pq_lut(q, codebook).reshape(nq, m * 256)
    probes = probe(q, cent, nprobe).long()
    pc = packed_codes.view(nlist, cap_b, m).long()
    ps = packed_slot.view(nlist, cap_b)
    po = packed_ok.view(nlist, cap_b).bool()
    offs = torch.arange(m, device=q.device) * 256
    kt = min(k, cap_b)
    neg = torch.tensor(NEG, dtype=q.dtype, device=q.device)
    cs, ci = [], []
    for p in range(nprobe):
        b = probes[:, p]
        fidx = (pc[b] + offs).reshape(nq, cap_b * m)
        s = adc_sum(torch.gather(flat_lut, 1, fidx).view(nq, cap_b, m))
        ts, tp = stable_topk(torch.where(po[b], s, neg), kt)
        cs.append(ts)
        ci.append(torch.gather(ps[b], 1, tp))
    return merge_candidates(torch.stack(cs, 1).reshape(nq, nprobe * kt),
                            torch.stack(ci, 1).reshape(nq, nprobe * kt), k)


def attention_mask(S: int, causal: bool, window: int, device):
    """``[S, S]`` bool, True where query ``i`` sees key ``j``: ``j <= i``
    when causal, and ``j > i - window`` when ``window > 0`` (the
    reference's ``attention_scores_mask``); None where every key is
    visible."""
    if not causal and window <= 0:
        return None
    i = torch.arange(S, device=device)
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window > 0:
        ok &= i[None, :] > i[:, None] - window
    return ok


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention with grouped-query heads, step by step as the reference
    ``repro.kernels.ref.flash_attention``: q:[B,H,S,dh], k/v:[B,Hkv,S,dh]
    (query head ``h`` reads KV head ``h // (H // Hkv)``) -> [B,H,S,dh].

    The logits are taken in the input dtype, cast to fp32 and scaled by
    ``1/sqrt(dh)``; causal masks the keys above the diagonal with -inf, and
    a ``window > 0`` the keys ``j <= i - window`` (the reference model's
    sliding window, ``repro.models.layers.attention_scores_mask``); the
    softmax is fp32 and its probabilities go back to ``q.dtype`` before the
    product with ``v``."""
    S, dh = q.shape[2], q.shape[3]
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (
        1.0 / math.sqrt(dh))
    mask = attention_mask(S, causal, window, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def attention_lse(q, k, *, causal: bool = True, window: int = 0):
    """Each row's natural log-sum-exp of its scaled logits over the keys it
    sees, fp32 ``[B,H,S]``: what the forward kernel writes on request. The
    logits are taken in fp32 from q and k."""
    S, dh = q.shape[2], q.shape[3]
    k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(dh))
    mask = attention_mask(S, causal, window, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(logits, dim=-1)


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal: bool = True,
                        window: int = 0):
    """The gradients of attention step by step, as the backward kernel
    computes them: ``(dq [B,H,S,dh], dk, dv [B,Hkv,S,dh])`` in q's dtype
    from q, k, v, the output ``o``, its gradient ``dout`` and the forward's
    log-sum-exp ``lse`` (fp32 ``[B,H,S]``).

    In fp32 from the inputs: P = exp(q kᵀ / sqrt(dh) - lse) over the
    visible pairs (0 elsewhere), D = rowsum(dO ⊙ o), dS = P ⊙ (dO vᵀ - D);
    P and dS are rounded to the input dtype before the products dv = Pᵀ dO,
    dq = dS k / sqrt(dh) and dk = dSᵀ q / sqrt(dh), as the kernel rounds its
    bf16 fragments; dk and dv are summed over each KV head's group of query
    heads."""
    dt = q.dtype
    B, H, S, dh = q.shape
    hkv = k.shape[1]
    rep = H // hkv
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, of, df = (t.float() for t in (q, k, v, o, dout))
    kr = kf.repeat_interleave(rep, dim=1)
    vr = vf.repeat_interleave(rep, dim=1)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
                  - lse.float()[..., None])
    mask = attention_mask(S, causal, window, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    d = (df * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", df, vr) - d)
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, df)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale

    def group_sum(t):
        return t.reshape(B, hkv, rep, S, dh).sum(2)

    return dq.to(dt), group_sum(dk).to(dt), group_sum(dv).to(dt)
