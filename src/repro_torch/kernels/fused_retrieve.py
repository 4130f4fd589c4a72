"""The fused retrieve kernels on the card: the wrappers of
``csrc/ivf_topk.cu``, ``csrc/sq8_topk.cu`` and ``csrc/pq_topk.cu``.

Each replaces the Pallas kernel of the same name in
``repro.kernels.fused_retrieve``:

* ``ivf_topk`` / ``pq_topk``: the probe (the top-``nprobe`` of
  ``q @ cent.T``) and, for PQ, the per-query lookup table stay plain tensor
  ops, as the XLA prologue does in JAX; the kernel scores each probed bucket
  of the bucket-contiguous packed mirror (fp32 rows, or PQ codes by table
  lookup) and emits its top-k as slot ids;
* ``sq8_topk``: the query is prescaled by the per-dimension scale here; the
  kernel scores int8 code tiles and emits each tile's top-k.

The candidates merge with a stable sort. The plain versions are in
``repro_torch.kernels.ref``; ``repro_torch.kernels.ops`` picks between them
by the device of the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import merge_candidates, pq_lut, probe

MAX_K = 128
SMEM_MAX = 232_448   # shared memory a block may use on Hopper (bytes)
# kernel launches since the last ops.reset_launch_counts()
launches = {"ivf_topk": 0, "sq8_topk": 0, "pq_topk": 0}


def ivf_topk_cuda(q: torch.Tensor, cent: torch.Tensor,
                  packed_vecs: torch.Tensor, packed_slot: torch.Tensor,
                  packed_ok: torch.Tensor, nprobe: int, k: int):
    """q:[nq,d] cent:[nlist,d] packed_vecs:[nlist*cap_b,d] fp32,
    packed_slot:[nlist*cap_b] int32, packed_ok:[nlist*cap_b] bool/uint8,
    all on one CUDA device; d % 4 == 0, 1 <= nprobe <= nlist,
    1 <= k <= 128. Returns ``(scores [nq,k] f32, slot ids [nq,k] int32)``
    with ``(NEG, -1)`` padding."""
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
    lib, fn = _build.entry("ivf_topk", 7, 5)
    probes = probe(q, cent, nprobe)
    out_s = torch.empty((nq, nprobe, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nprobe, k), dtype=torch.int32, device=dev)
    err = fn(q.data_ptr(), packed_vecs.data_ptr(), packed_slot.data_ptr(),
             packed_ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(), nq, d, rows // nlist, nprobe,
             k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ivf_topk", err)
    launches["ivf_topk"] += 1
    return merge_candidates(out_s.view(nq, nprobe * k),
                            out_i.view(nq, nprobe * k), k)


def sq8_topk_cuda(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  live: torch.Tensor, k: int):
    """q:[nq,d] fp32, codes:[N,d] int8, scale:[d] fp32, live:[N]
    bool/uint8, all on one CUDA device; d % 4 == 0, 1 <= k <= 128. Returns
    ``(scores [nq,k] f32, idx [nq,k] int32)`` with ``(NEG, -1)``
    padding."""
    dev = q.device
    _build.require(q, "q", (torch.float32,), 2, dev)
    _build.require(codes, "codes", (torch.int8,), 2, dev)
    _build.require(scale, "scale", (torch.float32,), 1, dev)
    _build.require(live, "live", (torch.bool, torch.uint8, torch.int8), 1,
                   dev)
    nq, d = q.shape
    n = codes.shape[0]
    if (codes.shape[1] != d or scale.shape[0] != d or live.shape[0] != n
            or n < 1 or nq < 1):
        raise ValueError(f"shapes q {tuple(q.shape)} codes "
                         f"{tuple(codes.shape)} scale {tuple(scale.shape)} "
                         f"live {tuple(live.shape)}")
    if d % 4 or not 1 <= k <= MAX_K:
        raise ValueError(f"need d % 4 == 0 and 1 <= k <= {MAX_K}, got "
                         f"d={d} k={k}")
    lib, fn = _build.entry("sq8_topk", 5, 4)
    n_tiles = -(-n // _build.tile_rows("sq8_topk"))
    qs = (q * scale[None, :]).contiguous()
    out_s = torch.empty((nq, n_tiles, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_tiles, k), dtype=torch.int32, device=dev)
    err = fn(qs.data_ptr(), codes.data_ptr(),
             live.view(torch.uint8).data_ptr(), out_s.data_ptr(),
             out_i.data_ptr(), nq, n, d, k,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "sq8_topk", err)
    launches["sq8_topk"] += 1
    return merge_candidates(out_s.view(nq, n_tiles * k),
                            out_i.view(nq, n_tiles * k), k)


def pq_topk_cuda(q: torch.Tensor, codebook: torch.Tensor, cent: torch.Tensor,
                 packed_codes: torch.Tensor, packed_slot: torch.Tensor,
                 packed_ok: torch.Tensor, nprobe: int, k: int):
    """q:[nq,d] codebook:[m,256,d/m] cent:[nlist,d] fp32,
    packed_codes:[nlist*cap_b, m] int32 in [0, 256),
    packed_slot:[nlist*cap_b] int32, packed_ok:[nlist*cap_b] bool/uint8,
    all on one CUDA device; 1 <= nprobe <= nlist, 1 <= k <= 128, and the
    query's [m, 256] table must fit in shared memory. Returns
    ``(scores [nq,k] f32, slot ids [nq,k] int32)`` with ``(NEG, -1)``
    padding."""
    dev = q.device
    _build.require(q, "q", (torch.float32,), 2, dev)
    _build.require(codebook, "codebook", (torch.float32,), 3, dev)
    _build.require(cent, "cent", (torch.float32,), 2, dev)
    _build.require(packed_codes, "packed_codes", (torch.int32,), 2, dev)
    _build.require(packed_slot, "packed_slot", (torch.int32,), 1, dev)
    _build.require(packed_ok, "packed_ok",
                   (torch.bool, torch.uint8, torch.int8), 1, dev)
    nq, d = q.shape
    m, ksub, dsub = codebook.shape
    nlist = cent.shape[0]
    rows = packed_codes.shape[0]
    if (ksub != 256 or m * dsub != d or cent.shape[1] != d
            or packed_codes.shape[1] != m or rows % nlist
            or packed_slot.shape[0] != rows or packed_ok.shape[0] != rows):
        raise ValueError(
            f"shapes q {tuple(q.shape)} codebook {tuple(codebook.shape)} "
            f"cent {tuple(cent.shape)} codes {tuple(packed_codes.shape)} "
            f"slot {tuple(packed_slot.shape)} ok {tuple(packed_ok.shape)}")
    smem = 4 * m * 256 + 8 * 8 * k
    if not 1 <= k <= MAX_K or not 1 <= nprobe <= nlist or smem > SMEM_MAX:
        raise ValueError(f"need 1 <= k <= {MAX_K}, 1 <= nprobe <= nlist and "
                         f"a table of at most {SMEM_MAX} bytes with the "
                         f"lists; got k={k} nprobe={nprobe} nlist={nlist} "
                         f"m={m} ({smem} bytes)")
    lib, fn = _build.entry("pq_topk", 7, 5)
    lut = pq_lut(q, codebook).contiguous()
    probes = probe(q, cent, nprobe)
    out_s = torch.empty((nq, nprobe, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nprobe, k), dtype=torch.int32, device=dev)
    err = fn(lut.data_ptr(), packed_codes.data_ptr(), packed_slot.data_ptr(),
             packed_ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(), nq, m, rows // nlist,
             nprobe, k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "pq_topk", err)
    launches["pq_topk"] += 1
    return merge_candidates(out_s.view(nq, nprobe * k),
                            out_i.view(nq, nprobe * k), k)
