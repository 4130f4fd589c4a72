"""Exact inner-product top-k on the card: the wrapper of
``csrc/topk_search.cu``.

Replaces ``repro.kernels.topk_search.topk_search_pallas``. The kernel scores
corpus tiles against a block of queries; block ``b`` of ``G`` walks tiles
``b, b + G, ...`` with one top-k list per query (``[nq, G, k]``
candidates, ``G`` at most two blocks per SM). The global merge takes the
top k by score, equal scores by lower row: the order of ``lax.top_k`` over
the whole score matrix, with which the JAX package merges. Above ``MAX_K`` the wrapper
takes ``topk_large.flat_topk`` (every score, then an exact select, in the
same order). The plain version is ``repro_torch.kernels.ref.topk_search``;
``repro_torch.kernels.ops`` picks between them by the device of the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, topk_large
from repro_torch.kernels.ref import (NEG, merge_candidates, pad_cols,
                                     padded_width)

MAX_K = 128
BLOCKS_PER_SM = 2   # the kernel's residency at k <= 56


def topk_search_cuda(q: torch.Tensor, vecs: torch.Tensor, live: torch.Tensor,
                     k: int):
    """q:[nq,d] vecs:[N,d] fp32, live:[N] bool/uint8, all on one CUDA
    device; k >= 1. Returns ``(scores [nq,k] f32, idx [nq,k] int32)`` with
    ``(NEG, -1)`` padding. At k <= ``MAX_K`` and d % 4 != 0 the kernel
    reads q and vecs zero-padded to a multiple of 4 columns: a copy of the
    corpus per call (``TorchVectorDB`` keeps its rows padded instead)."""
    dev = q.device
    _build.require(q, "q", (torch.float32,), 2, dev)
    _build.require(vecs, "vecs", (torch.float32,), 2, dev)
    _build.require(live, "live", (torch.bool, torch.uint8, torch.int8), 1,
                   dev)
    nq, d = q.shape
    n = vecs.shape[0]
    if vecs.shape[1] != d or live.shape[0] != n or n < 1 or nq < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} vecs "
                         f"{tuple(vecs.shape)} live {tuple(live.shape)}")
    if k < 1:
        raise ValueError(f"need k >= 1, got k={k}")
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    if k > MAX_K:
        out = topk_large.flat_topk(q, vecs, live, k)
        count_launch("topk_search")
        return out
    d = padded_width(d)
    q, vecs = pad_cols(q, d), pad_cols(vecs, d)
    lib, fn = _build.entry("topk_search", 5, 5)
    n_tiles = -(-n // _build.tile_rows("topk_search"))
    n_lists = min(n_tiles, BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out_s = torch.empty((nq, n_lists, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_lists, k), dtype=torch.int32, device=dev)
    err = fn(q.data_ptr(), vecs.data_ptr(), live.view(torch.uint8).data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(), nq, n, d, k, n_lists,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "topk_search", err)
    count_launch("topk_search")
    return merge_by_row(out_s.view(nq, n_lists * k),
                        out_i.view(nq, n_lists * k), k)


def _row_key(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A 64-bit key per candidate: the score's order-preserving int32 bits
    (-0.0 as +0.0) above the row's complement, so that one ``torch.topk``
    over it takes higher scores first and, among equal scores, the lower
    row; no two candidates of distinct rows tie. ``rows`` broadcasts."""
    bits = (scores + 0.0).view(torch.int32)           # -0.0 scores as +0.0
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)          # int order = float order
    # key * 2^32 + (2^31 - 1 - row), formed in int64 by one add
    return torch.add(0x7FFFFFFF - rows.long(), key, alpha=1 << 32)


def merge_by_row(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Global top-k of candidates ``[nq, C]`` in any order of lists, in the
    order of ``lax.top_k`` over the whole score matrix: by score, equal
    scores by lower row. One ``torch.topk`` over ``_row_key``. Padding
    ``(NEG, -1)`` stays padding."""
    key = _row_key(cand_s, cand_i)
    pos = torch.topk(key, min(k, key.shape[1]), dim=1).indices
    return merge_candidates(torch.gather(cand_s, 1, pos),
                            torch.gather(cand_i, 1, pos), k)


def select_by_row(scores: torch.Tensor, live: torch.Tensor, k: int):
    """``ref.masked_topk`` (the top-``k`` of ``scores [nq, N]`` over the
    ``live [N]`` columns, ``(NEG, -1)`` padded, ``lax.top_k``'s order) by
    one ``torch.topk`` over ``_row_key`` instead of a stable sort of every
    row."""
    masked = torch.where(live.bool()[None, :], scores,
                         torch.tensor(NEG, dtype=scores.dtype,
                                      device=scores.device))
    cols = torch.arange(scores.shape[1], device=scores.device,
                        dtype=torch.int32)
    pos = torch.topk(_row_key(masked, cols[None, :]),
                     min(k, scores.shape[1]), dim=1).indices
    return merge_candidates(torch.gather(masked, 1, pos), pos.int(), k)
