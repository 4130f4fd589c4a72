"""Collective helpers: the port of ``repro.distributed.collectives``.

``make_sharded_topk`` is the distributed retrieval step: the corpus is
sharded over the ("pod", "data") mesh dims, each rank computes a *local*
top-k of its rows (``local_topk``: the hand-written ``topk_search`` kernel
on the card, its plain version on the CPU), and the k winners (not the
score matrix) are all-gathered and merged. A query's traffic is
O(shards·k) instead of O(N).

``compressed_psum`` is the int8 error-feedback all-reduce of the
data-parallel gradient reduction.

Both are SPMD: every rank of the group calls them with its own shard.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.distributed.sharding import mesh_shape
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG, merge_candidates

__all__ = ["NEG", "local_topk", "make_sharded_topk", "corpus_group",
           "compressed_psum"]


def local_topk(q: torch.Tensor, vecs: torch.Tensor, live: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of ``q [nq, d]`` over the live rows of ``vecs [N,
    d]``: ``(scores [nq, k], rows [nq, k] int32)`` in ``lax.top_k``'s order.
    A shard with fewer than k live rows pads with ``(NEG, -1)`` (the
    reference gives a dead row's id beside its NEG score; either way the
    merge drops it)."""
    return ops.topk_search(q, vecs, live, k)


def corpus_group(mesh, corpus_axes=("pod", "data")):
    """``(process group, shard id, n_shards)`` of this rank over the mesh
    dims of ``corpus_axes`` that the mesh has (several dims as one
    flattened group, the major dim first)."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in corpus_axes if a in shape)
    if not axes:
        raise ValueError(f"the mesh {shape} has none of {corpus_axes}")
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    if len(axes) > 1:
        sub = sub._flatten()
    shard = 0
    for a in axes:
        shard = shard * shape[a] + mesh.get_local_rank(a)
    n = 1
    for a in axes:
        n *= shape[a]
    return sub.get_group(), shard, n


def make_sharded_topk(mesh, k: int, corpus_axes=("pod", "data")
                      ) -> Tuple[Callable, int]:
    """Returns ``(fn, n_shards)``: ``fn(q, vecs, live) -> (scores [nq, k],
    global ids [nq, k])``, called on every rank of the corpus dims with
    the replicated queries and that rank's rows. Global id = local row +
    shard * rows_per_shard (pads stay -1); the merge keeps ``lax.top_k``'s
    order over the shard-major candidates, so ties go to the lower global
    id, as the reference's."""
    import torch.distributed._functional_collectives as funcol

    group, shard, n_shards = corpus_group(mesh, corpus_axes)
    # all_gather_single replaces all_gather_tensor in newer torch releases
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor

    def fn(q, vecs, live):
        s, i = local_topk(q, vecs, live, k)
        gi = torch.where(i < 0, torch.full_like(i, -1),
                         i + shard * vecs.shape[0])
        # [n_shards * nq, k] -> [nq, n_shards * k], shard-major per query
        s_all = gather(s.contiguous(), 0, group)
        gi_all = gather(gi.contiguous(), 0, group)
        nq = q.shape[0]
        s_all = s_all.view(n_shards, nq, k).transpose(0, 1).reshape(nq, -1)
        gi_all = gi_all.view(n_shards, nq, k).transpose(0, 1).reshape(nq, -1)
        return merge_candidates(s_all, gi_all, k)

    return fn, n_shards


def compressed_psum(x: torch.Tensor, group, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantized sum over ``group`` with error feedback: ``x + err``
    is rounded to int8 codes with one scale (its largest magnitude / 127),
    the residual is kept as the new ``err``, and the dequantized values are
    summed in fp32 over the group. Returns ``(sum, new_err)``. ``group``
    is anything ``torch.distributed._functional_collectives`` takes (a
    process group, a 1-d mesh, ``(mesh, dim)``)."""
    import torch.distributed._functional_collectives as funcol

    x = x.float() + err
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    new_err = x - deq
    # the int8 payload is what a link would carry; the sum runs in fp32
    total = funcol.all_reduce(deq, "sum", group)
    return funcol.wait_tensor(total), new_err
