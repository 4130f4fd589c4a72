"""Exact inner-product top-k on the card: the wrapper of
``csrc/topk_search.cu``.

Replaces ``repro.kernels.topk_search.topk_search_pallas``. The kernel scores
corpus tiles against a block of queries; block ``b`` of ``G`` walks tiles
``b, b + G, ...`` with one top-k list per query (``[nq, G, k]``
candidates, ``G`` at most two blocks per SM). The global merge takes the
top k by score, equal scores by lower row: the order of ``lax.top_k`` over
the whole score matrix, with which the JAX package merges. The plain version is
``repro_torch.kernels.ref.topk_search``; ``repro_torch.kernels.ops`` picks
between them by the device of the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import merge_candidates

MAX_K = 128
BLOCKS_PER_SM = 2   # the kernel's residency at k <= 56
launches = 0   # kernel launches since the last ops.reset_launch_counts()


def topk_search_cuda(q: torch.Tensor, vecs: torch.Tensor, live: torch.Tensor,
                     k: int):
    """q:[nq,d] vecs:[N,d] fp32, live:[N] bool/uint8, all on one CUDA
    device; d % 4 == 0, 1 <= k <= 128. Returns ``(scores [nq,k] f32,
    idx [nq,k] int32)`` with ``(NEG, -1)`` padding."""
    global launches
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
    if d % 4 or not 1 <= k <= MAX_K:
        raise ValueError(f"need d % 4 == 0 and 1 <= k <= {MAX_K}, got "
                         f"d={d} k={k}")
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
    launches += 1
    return merge_by_row(out_s.view(nq, n_lists * k),
                        out_i.view(nq, n_lists * k), k)


def merge_by_row(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Global top-k of candidates ``[nq, C]`` in any order of lists, in the
    order of ``lax.top_k`` over the whole score matrix: by score, equal
    scores by lower row. One ``torch.topk`` over a 64-bit key, the score's
    order-preserving int32 bits above the row's complement, so no two
    candidates tie. Padding ``(NEG, -1)`` stays padding."""
    bits = (cand_s + 0.0).view(torch.int32)          # -0.0 scores as +0.0
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)          # int order = float order
    key = (key.long() << 32) | (0x7FFFFFFF - cand_i.long())
    pos = torch.topk(key, min(k, key.shape[1]), dim=1).indices
    return merge_candidates(torch.gather(cand_s, 1, pos),
                            torch.gather(cand_i, 1, pos), k)
