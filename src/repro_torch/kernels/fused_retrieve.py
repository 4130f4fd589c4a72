"""IVF probe -> score -> select on the card: the wrapper of
``csrc/ivf_topk.cu``.

Replaces ``repro.kernels.fused_retrieve.ivf_topk_pallas``. The probe (the
top-``nprobe`` of ``q @ cent.T``) stays a plain tensor op, as the XLA
prologue does in JAX; the kernel scores each probed bucket of the
bucket-contiguous packed mirror and emits its top-k as slot ids; the
``[nq, nprobe*k]`` candidates merge with a stable sort. The plain version is
``repro_torch.kernels.ref.ivf_topk``; ``repro_torch.kernels.ops`` picks
between them by the device of the inputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import merge_candidates, probe

MAX_K = 128
launches = 0   # kernel launches since the last ops.reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.library("ivf_topk")
    fn = lib.ivf_topk_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def ivf_topk_cuda(q: torch.Tensor, cent: torch.Tensor,
                  packed_vecs: torch.Tensor, packed_slot: torch.Tensor,
                  packed_ok: torch.Tensor, nprobe: int, k: int):
    """q:[nq,d] cent:[nlist,d] packed_vecs:[nlist*cap_b,d] fp32,
    packed_slot:[nlist*cap_b] int32, packed_ok:[nlist*cap_b] bool/uint8,
    all on one CUDA device; d % 4 == 0, 1 <= nprobe <= nlist,
    1 <= k <= 128. Returns ``(scores [nq,k] f32, slot ids [nq,k] int32)``
    with ``(NEG, -1)`` padding."""
    global launches
    dev = q.device
    _build.require(q, "q", (torch.float32,), 2, dev)
    _build.require(cent, "cent", (torch.float32,), 2, dev)
    _build.require(packed_vecs, "packed_vecs", (torch.float32,), 2, dev)
    _build.require(packed_slot, "packed_slot", (torch.int32,), 1, dev)
    _build.require(packed_ok, "packed_ok",
                   (torch.bool, torch.uint8, torch.int8), 1, dev)
    nq, d = q.shape
    nlist = cent.shape[0]
    rows = packed_vecs.shape[0]
    if (cent.shape[1] != d or packed_vecs.shape[1] != d or rows % nlist
            or packed_slot.shape[0] != rows or packed_ok.shape[0] != rows):
        raise ValueError(
            f"shapes q {tuple(q.shape)} cent {tuple(cent.shape)} packed "
            f"{tuple(packed_vecs.shape)} slot {tuple(packed_slot.shape)} "
            f"ok {tuple(packed_ok.shape)}")
    if d % 4 or not 1 <= k <= MAX_K or not 1 <= nprobe <= nlist:
        raise ValueError(f"need d % 4 == 0, 1 <= k <= {MAX_K}, "
                         f"1 <= nprobe <= nlist; got d={d} k={k} "
                         f"nprobe={nprobe} nlist={nlist}")
    lib, fn = _entry()
    probes = probe(q, cent, nprobe)
    out_s = torch.empty((nq, nprobe, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nprobe, k), dtype=torch.int32, device=dev)
    err = fn(q.data_ptr(), packed_vecs.data_ptr(), packed_slot.data_ptr(),
             packed_ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(), nq, d, rows // nlist, nprobe,
             k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ivf_topk", err)
    launches += 1
    return merge_candidates(out_s.view(nq, nprobe * k),
                            out_i.view(nq, nprobe * k), k)
