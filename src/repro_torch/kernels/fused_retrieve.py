"""The fused retrieve kernels on the card: the wrappers of
``csrc/ivf_topk.cu``, ``csrc/sq8_topk.cu`` and ``csrc/pq_topk.cu``.

Each replaces the Pallas kernel of the same name in
``repro.kernels.fused_retrieve``:

* ``ivf_topk`` / ``pq_topk``: the probe (the top-``nprobe`` of
  ``q @ cent.T``) and, for PQ, the per-query lookup table stay plain tensor
  ops, as the XLA prologue does in JAX; the kernel scores the probed
  buckets of the bucket-contiguous packed mirror (fp32 rows, or uint8 PQ
  codes by table lookup) and emits top-k lists as slot ids: one per
  (query, probe), each probed bucket read once for up to ``IVF_QUERIES``
  queries (``ivf_topk``, whose entry point first inverts the probes into
  per-bucket query lists), or one per group of ``PQ_GROUP`` probes
  (``pq_topk``); a last kernel merges them by (score, probe rank, row);
* ``sq8_topk``: the query is prescaled by the per-dimension scale and split
  into int8 limbs here (``sq8_limbs``); the kernel scores int8 code tiles
  on the int8 tensor cores and emits one top-k list per block, merged by a
  second kernel by (score, row).

The second kernels are launched by the same C entry point as the first.

The plain versions are in ``repro_torch.kernels.ref``;
``repro_torch.kernels.ops`` picks between them by the device of the inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pq_lut, probe

MAX_K = 128
SMEM_MAX = 232_448   # shared memory a block may use on Hopper (bytes)
SQ8_LIMBS = 4        # int8 limbs of a prescaled query row (csrc LIMBS)
PQ_GROUP = 4         # probes per pq_topk block: one table load per group
IVF_QUERIES = 8      # queries an ivf_topk work item scores a bucket for


def ivf_topk_cuda(q: torch.Tensor, cent: torch.Tensor,
                  packed_vecs: torch.Tensor, packed_slot: torch.Tensor,
                  packed_ok: torch.Tensor, nprobe: int, k: int):
    """q:[nq,d] cent:[nlist,d] packed_vecs:[nlist*cap_b,d] fp32,
    packed_slot:[nlist*cap_b] int32, packed_ok:[nlist*cap_b] bool/uint8,
    all on one CUDA device; d % 4 == 0, 1 <= nprobe <= nlist,
    1 <= k <= 128. Returns ``(scores [nq,k] f32, slot ids [nq,k] int32)``
    with ``(NEG, -1)`` padding, in ``ref.ivf_topk``'s order: equal scores
    keep the lower probe rank, then the lower packed row."""
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
    lib, fn = _build.entry("ivf_topk", 12, 7)
    # the centroid scores as the plain probe computes them; the entry point
    # selects the probe from them (up to MAX_K probes; wider, it takes the
    # plain probe)
    if nprobe <= MAX_K:
        cscores = (q @ cent.T).contiguous()
        probes = torch.empty((nq, nprobe), dtype=torch.int32, device=dev)
    else:
        cscores, probes = None, probe(q, cent, nprobe)
    scratch = torch.empty(_scratch_ints(lib, nq, nprobe, nlist),
                          dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, nprobe, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nprobe, k), dtype=torch.int32, device=dev)
    out_p = torch.empty((nq, nprobe, k), dtype=torch.int32, device=dev)
    top_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    top_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    err = fn(q.data_ptr(), packed_vecs.data_ptr(), packed_slot.data_ptr(),
             packed_ok.view(torch.uint8).data_ptr(),
             None if cscores is None else cscores.data_ptr(),
             probes.data_ptr(), scratch.data_ptr(), out_s.data_ptr(),
             out_i.data_ptr(), out_p.data_ptr(), top_s.data_ptr(),
             top_i.data_ptr(), nq, d, nlist, rows // nlist, nprobe, k, blocks,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ivf_topk", err)
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    count_launch("ivf_topk")
    return top_s, top_i


def _scratch_ints(lib, nq: int, nprobe: int, nlist: int) -> int:
    """Ints of ``ivf_topk``'s device scratch: the probes inverted into
    per-bucket query lists and work items (``ivf_topk_scratch_ints``)."""
    fn = lib.ivf_topk_scratch_ints
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(nq, nprobe, nlist)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0 ** e as fp32 for int32 ``e`` in [-126, 127], built from its bits
    (exact on every device, as the kernel builds it)."""
    return ((e + 127) << 23).view(torch.float32)


def sq8_limbs(qs: torch.Tensor):
    """Split prescaled query rows ``qs [nq, d]`` fp32 into ``SQ8_LIMBS``
    int8 limbs, every step exact in fp32: with ``2^e`` the least power of
    two at or above the row's ``max |qs|`` (``e`` held in [-96, 120]), limb
    0 is ``round(qs * 2^(6 - e))`` and each further limb ``round(residue *
    2^7)``, all in [-64, 64]; ``qs`` equals ``sum_l 2^(e - 6 - 7 l) *
    limb_l`` up to ``2^(e - 7 SQ8_LIMBS)`` per element. Returns ``(limbs
    [SQ8_LIMBS, nq, d] int8, e [nq] int32)``: the A operand of the limb
    product (``csrc/sq8_limb.cuh``) and the exponents its weights come
    from."""
    bits = qs.abs().amax(1).view(torch.int32)
    # the exponent field of amax rounded up to a power of two (amax = 0
    # and subnormal amax land below the floor): ((bits - 1) >> 23) - 126
    e = ((bits - (1 + (126 << 23))) >> 23).clamp_(-96, 120)
    x = qs * ((133 - e) << 23).view(torch.float32)[:, None]   # 2^(6 - e)
    r = torch.empty((SQ8_LIMBS,) + tuple(qs.shape), dtype=qs.dtype,
                    device=qs.device)
    for l in range(SQ8_LIMBS):
        torch.round(x, out=r[l])
        if l + 1 < SQ8_LIMBS:
            x.sub_(r[l]).mul_(128.0)
    return r.to(torch.int8), e


def sq8_limb_scores(limbs: torch.Tensor, e: torch.Tensor,
                    codes: torch.Tensor) -> torch.Tensor:
    """The scores ``[nq, N]`` that ``csrc/sq8_topk.cu`` and
    ``csrc/quant_score.cu`` compute, bit for bit: each limb's exact integer
    dot product ``a_l`` with the codes, converted to fp32 (rounded to
    nearest past d = 2,064), times its weight ``w_l = 2^(e - 6 - 7 l)`` (exact),
    added in the order ``((a_0 w_0 + a_1 w_1) + a_2 w_2) + a_3 w_3``."""
    c = codes.double().T
    out = None
    for l, limb in enumerate(limbs):
        term = (limb.double() @ c).float() * _pow2(e - 6 - 7 * l)[:, None]
        out = term if out is None else out + term
    return out


def sq8_topk_cuda(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  live: torch.Tensor, k: int):
    """q:[nq,d] fp32, codes:[N,d] int8, scale:[d] fp32, live:[N]
    bool/uint8, all on one CUDA device; d % 4 == 0 (the kernel keeps the
    query block's limbs resident in shared memory at d <= 384 and streams
    them with the codes above that), 1 <= k <= 128. Returns
    ``(scores [nq,k] f32, idx [nq,k] int32)`` with ``(NEG, -1)`` padding:
    the top-k of ``sq8_limb_scores``, within 1e-5 of ``ref.sq8_topk``'s
    scores."""
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
    lib, fn = _build.entry("sq8_topk", 8, 5, "s8")
    n_tiles = -(-n // _build.tile_rows("sq8_topk"))
    n_lists = min(n_tiles, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    limbs, e = sq8_limbs(q * scale[None, :])
    out_s = torch.empty((nq, n_lists, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_lists, k), dtype=torch.int32, device=dev)
    top_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    top_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    err = fn(limbs.data_ptr(), e.data_ptr(), codes.data_ptr(),
             live.view(torch.uint8).data_ptr(), out_s.data_ptr(),
             out_i.data_ptr(), top_s.data_ptr(), top_i.data_ptr(), nq, n, d,
             k, n_lists, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "sq8_topk", err)
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    count_launch("sq8_topk")
    return top_s, top_i


def pq_topk_cuda(q: torch.Tensor, codebook: torch.Tensor, cent: torch.Tensor,
                 packed_codes: torch.Tensor, packed_slot: torch.Tensor,
                 packed_ok: torch.Tensor, nprobe: int, k: int):
    """q:[nq,d] codebook:[m,256,d/m] cent:[nlist,d] fp32,
    packed_codes:[nlist*cap_b, m] uint8 (the DB's mirror, read as it is)
    or int32 in [0, 256) (the reference's codes: range-checked, then
    narrowed to uint8 on the device; a code outside raises ValueError),
    packed_slot:[nlist*cap_b] int32, packed_ok:[nlist*cap_b] bool/uint8,
    all on one CUDA device; 1 <= nprobe <= nlist, 1 <= k <= 128, and the
    query's [m, 256] table must fit in shared memory. Returns ``(scores
    [nq,k] f32, slot ids [nq,k] int32)`` with ``(NEG, -1)`` padding."""
    dev = q.device
    _build.require(q, "q", (torch.float32,), 2, dev)
    _build.require(codebook, "codebook", (torch.float32,), 3, dev)
    _build.require(cent, "cent", (torch.float32,), 2, dev)
    _build.require(packed_codes, "packed_codes", (torch.uint8, torch.int32),
                   2, dev)
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
    # the table, 8 warps' lists and buffers, the ok masks and list of a
    # probe group's 32-row groups
    smem = (4 * m * 256 + 8 * 8 * (k + 32)
            + 8 * PQ_GROUP * -(-(rows // nlist) // 32))
    if not 1 <= k <= MAX_K or not 1 <= nprobe <= nlist or smem > SMEM_MAX:
        raise ValueError(f"need 1 <= k <= {MAX_K}, 1 <= nprobe <= nlist and "
                         f"a table of at most {SMEM_MAX} bytes with the "
                         f"lists; got k={k} nprobe={nprobe} nlist={nlist} "
                         f"m={m} ({smem} bytes)")
    if packed_codes.dtype == torch.int32:
        packed_codes = narrow_codes(packed_codes)
    lib, fn = _build.entry("pq_topk", 10, 6, "u8")
    lut = pq_lut(q, codebook).contiguous()
    probes = probe(q, cent, nprobe)
    groups = -(-nprobe // PQ_GROUP)
    out_s = torch.empty((nq, groups, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, groups, k), dtype=torch.int32, device=dev)
    out_p = torch.empty((nq, groups, k), dtype=torch.int32, device=dev)
    top_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    top_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    err = fn(lut.data_ptr(), packed_codes.data_ptr(), packed_slot.data_ptr(),
             packed_ok.view(torch.uint8).data_ptr(), probes.data_ptr(),
             out_s.data_ptr(), out_i.data_ptr(), out_p.data_ptr(),
             top_s.data_ptr(), top_i.data_ptr(), nq, m, rows // nlist,
             nprobe, PQ_GROUP, k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "pq_topk", err)
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    count_launch("pq_topk")
    return top_s, top_i


def narrow_codes(codes: torch.Tensor) -> torch.Tensor:
    """int32 PQ codes -> uint8 on their device; ValueError unless every
    code is in [0, 256). One device-to-host read of the range."""
    if codes.numel():
        lo, hi = torch.stack(torch.aminmax(codes)).tolist()
        if lo < 0 or hi > 255:
            raise ValueError(f"packed_codes must lie in [0, 256) to narrow "
                             f"to uint8; got [{lo}, {hi}]")
    return codes.to(torch.uint8)
