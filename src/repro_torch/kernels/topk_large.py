"""The large-k path of the DB kernels on the card: the wrapper of
``csrc/topk_large.cu``.

``topk_search``, ``ivf_topk``, ``sq8_topk`` and ``pq_topk`` keep their
per-block lists in registers and shared memory for k up to 128; above
that (and, for ``pq_topk``, when the query's lookup table does not fit in
shared memory) their wrappers come here. A scoring kernel writes every
candidate's score (the flat rows; the probed buckets' rows, probe-major;
``sq8_topk``'s come from ``quant_score``'s kernel), and a selection kernel
takes the exact top-k of each query's row by (score, position): the order
of ``lax.top_k`` over the whole score matrix, which is the order of
``merge_candidates`` over the probe-major candidates. Each function here is
called by the wrapper of the kernel it stands in for, which counts the
launch under that kernel's name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

def _entry(name: str, n_ptr: int, n_int: int):
    return _build.entry("topk_large", n_ptr, n_int, name)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def select(scores: torch.Tensor, k: int, live=None, probes=None, slot=None,
           cap_b: int = 0):
    """Top-``k`` of ``scores [nq, C]`` fp32 by (score, position), with
    ``(NEG, -1)`` padding. ``live [C]`` (optional) masks positions; with
    ``probes [nq, nprobe]`` and ``slot [nlist*cap_b]`` int32 position ``p``
    reports ``slot[probes[q, p // cap_b] * cap_b + p % cap_b]``, else ``p``.
    """
    lib, fn = _entry("select_f32", 7, 5)
    dev = scores.device
    nq, c = scores.shape
    count = lib.topk_large_scratch_keys
    count.argtypes = [ctypes.c_int] * 3
    count.restype = ctypes.c_longlong
    n_keys = count(nq, c, k)
    keys = (torch.empty(n_keys, dtype=torch.int64, device=dev)
            if n_keys else None)
    top_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    top_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    nprobe = 0 if probes is None else probes.shape[1]
    err = fn(scores.data_ptr(),
             None if live is None else live.view(torch.uint8).data_ptr(),
             None if probes is None else probes.data_ptr(),
             None if slot is None else slot.data_ptr(),
             None if keys is None else keys.data_ptr(),
             top_s.data_ptr(), top_i.data_ptr(), nq, c, k, cap_b, nprobe,
             _stream(dev))
    _build.check(lib, "topk_large", err)
    return top_s, top_i


def flat_topk(q, vecs, live, k: int):
    """``topk_search`` at any k and row width: the ``[nq, N]`` scores of
    the live rows, then ``select``."""
    lib, fn = _entry("flat_f32", 4, 3)
    nq, d = q.shape
    n = vecs.shape[0]
    scores = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    live = live.view(torch.uint8)
    err = fn(q.data_ptr(), vecs.data_ptr(), live.data_ptr(),
             scores.data_ptr(), nq, n, d, _stream(q.device))
    _build.check(lib, "topk_large", err)
    return select(scores, k)


def ivf_topk(q, probes, packed_vecs, packed_slot, packed_ok, cap_b: int,
             k: int):
    """``ivf_topk`` at any k and row width: the probed buckets' rows scored
    probe-major into ``[nq, nprobe * cap_b]``, then ``select``."""
    lib, fn = _entry("ivf_f32", 5, 4)
    nq, d = q.shape
    nprobe = probes.shape[1]
    scores = torch.empty((nq, nprobe * cap_b), dtype=torch.float32,
                         device=q.device)
    err = fn(q.data_ptr(), packed_vecs.data_ptr(),
             packed_ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
             scores.data_ptr(), nq, d, cap_b, nprobe, _stream(q.device))
    _build.check(lib, "topk_large", err)
    return select(scores, k, probes=probes, slot=packed_slot, cap_b=cap_b)


def pq_topk(lut, probes, packed_codes, packed_slot, packed_ok, cap_b: int,
            k: int):
    """``pq_topk`` at any k and table size: ``lut [nq, m, 256]`` read from
    global memory (L2-resident), the probed buckets' rows scored
    probe-major, then ``select``."""
    lib, fn = _entry("pq_u8", 5, 4)
    nq, m = lut.shape[:2]
    nprobe = probes.shape[1]
    scores = torch.empty((nq, nprobe * cap_b), dtype=torch.float32,
                         device=lut.device)
    err = fn(lut.data_ptr(), packed_codes.data_ptr(),
             packed_ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
             scores.data_ptr(), nq, m, cap_b, nprobe, _stream(lut.device))
    _build.check(lib, "topk_large", err)
    return select(scores, k, probes=probes, slot=packed_slot, cap_b=cap_b)

