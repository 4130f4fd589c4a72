"""Exact inner-product top-k on the card: the wrapper of
``csrc/topk_search.cu``.

Replaces ``repro.kernels.topk_search.topk_search_pallas``. The kernel scores
corpus tiles against a block of queries and keeps each tile's top-k
(``[nq, n_tiles, k]`` candidates); the global merge is a stable sort here,
as the JAX package merges with ``lax.top_k``. The plain version is
``repro_torch.kernels.ref.topk_search``; ``repro_torch.kernels.ops`` picks
between them by the device of the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import merge_candidates

MAX_K = 128
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
    lib, fn = _build.entry("topk_search", 5, 4)
    n_tiles = -(-n // _build.tile_rows("topk_search"))
    out_s = torch.empty((nq, n_tiles, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_tiles, k), dtype=torch.int32, device=dev)
    err = fn(q.data_ptr(), vecs.data_ptr(), live.view(torch.uint8).data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(), nq, n, d, k,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "topk_search", err)
    launches += 1
    return merge_candidates(out_s.view(nq, n_tiles * k),
                            out_i.view(nq, n_tiles * k), k)
