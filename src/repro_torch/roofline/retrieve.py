"""Analytic device-memory traffic of one retrieve micro-batch, fused against
unfused: the port of ``repro.roofline.retrieve``.

The model is the reference's, term for term (``hbm_bytes`` and
``roofline`` give its numbers under its ``HW``):

* **bound** — the corpus payload the search must stream once (vectors,
  int8 codes or packed PQ codes of every scored row) plus the queries and
  the output lists. No exact search can move less.
* **unfused** — bound + the plain ladder's materialised intermediates: the
  ``[nq, N]`` (or ``[nq, nprobe, cap_b]``) score matrix written and read
  by the top-k, the gathered ``[nq, nprobe, cap_b, d]`` candidates, the
  int8 -> fp32 corpus upcast of the SQ8 plain path and the PQ path's
  gathered codes and table values.
* **fused** — bound + the small ``[nq, n_tiles * k]`` candidate lists
  (written once, merged once) and the IVF probe prologue.

Under ``H100`` the record also carries the port kernels' own traffic where
it differs from the model's (``port_*`` keys, ``port_hbm_bytes``): the
bucket-major ``ivf_topk`` (``csrc/ivf_topk.cu``) reads each probed bucket
once per work item of up to ``IVF_QUERIES`` queries that probe it, not
once per (query, probe) pair. With the probes spread evenly, a batch's
``nq * nprobe`` pairs fall on ``min(nlist, nq * nprobe)`` buckets, each
read ``ceil(pairs a bucket / IVF_QUERIES)`` times.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.kernels.fused_retrieve import IVF_QUERIES
from repro_torch.roofline.analysis import H100, HW

F32 = 4
I32 = 4
I8 = 1


@dataclass(frozen=True)
class RetrieveShape:
    """One retrieve micro-batch against one index configuration."""

    nq: int                 # coalesced queries per launch
    n: int                  # live corpus rows
    d: int                  # embedding dim
    k: int                  # top-k
    index_type: str = "flat"   # flat | ivf
    quant: str = "none"        # none | sq8 | pq
    nlist: int = 64
    nprobe: int = 8
    bucket_cap: int = 0        # 0 -> auto (mirrors DBConfig: 4*n/nlist)
    pq_m: int = 8
    bn: int = 1024             # flat-scan tile rows (kernel default)

    @property
    def cap_b(self) -> int:
        return self.bucket_cap or max(16, int(4 * self.n / self.nlist))

    @property
    def rows_scored(self) -> int:
        """Rows each query's scan touches (R)."""
        if self.index_type == "ivf":
            return self.nprobe * self.cap_b
        return self.n


def _io_bytes(s: RetrieveShape) -> float:
    return s.nq * s.d * F32 + s.nq * s.k * (F32 + I32)


def _probe_bytes(s: RetrieveShape) -> float:
    return s.nlist * s.d * F32 + s.nq * s.nlist * F32   # centroid scan


def _corpus_bytes(s: RetrieveShape) -> float:
    """Payload bytes the search must stream from device memory (the bound
    term)."""
    if s.index_type == "ivf":
        r = s.rows_scored
        probe = _probe_bytes(s)
        if s.quant == "pq":
            # packed int32 codes + per-query LUT build (write + read)
            return s.nq * r * s.pq_m * I32 + 2 * s.nq * s.pq_m * 256 * F32 \
                + probe
        return s.nq * r * s.d * F32 + probe
    if s.quant == "sq8":
        return s.n * s.d * I8
    return s.n * s.d * F32


def hbm_bytes(s: RetrieveShape, fused: bool) -> Dict[str, float]:
    """Device bytes for one retrieve micro-batch: ``{total, bound,
    terms}``."""
    bound = _corpus_bytes(s) + _io_bytes(s)
    terms: Dict[str, float] = {"bound": bound}
    r = s.rows_scored
    if fused:
        # per-tile candidate lists (scores f32 + ids i32), written by the
        # kernel and re-read once by the merge
        nt = s.nprobe if s.index_type == "ivf" else -(-s.n // s.bn)
        terms["candidates"] = 2 * s.nq * nt * s.k * (F32 + I32)
    else:
        # score matrix written, then re-read by the top-k
        terms["score_matrix"] = 2 * s.nq * r * F32
        if s.index_type == "ivf":
            if s.quant == "pq":
                # gathered [nq,np,cap_b,m] codes + gathered LUT values,
                # each written then re-read
                terms["gather"] = 4 * s.nq * r * s.pq_m * I32 \
                    + 2 * s.nq * r * s.pq_m * F32
            else:
                # gathered [nq,np,cap_b,d] candidate tensor (write + read)
                terms["gather"] = 2 * s.nq * r * s.d * F32
        elif s.quant == "sq8":
            # plain int8->f32 corpus upcast materialised (write + read)
            terms["upcast"] = 2 * s.n * s.d * F32
    total = sum(terms.values())
    return {"total": total, "bound": bound, "terms": terms}


def port_hbm_bytes(s: RetrieveShape) -> Optional[Dict[str, float]]:
    """The fused path's bytes as the port's kernels move them, where they
    differ from ``hbm_bytes(s, fused=True)``: the bucket-major IVF scan
    over fp32 rows (its packed rows and their ok bytes, a read per work
    item). None where the port moves the model's bytes."""
    if s.index_type != "ivf" or s.quant != "none":
        return None
    pairs = s.nq * s.nprobe
    buckets = min(s.nlist, pairs)
    reads = buckets * math.ceil(pairs / buckets / IVF_QUERIES)
    scan = reads * s.cap_b * (s.d * F32 + 1)   # rows + their ok bytes
    terms = dict(hbm_bytes(s, fused=True)["terms"])
    bound = scan + _probe_bytes(s) + _io_bytes(s)
    terms["bound"] = bound
    return {"total": sum(terms.values()), "bound": bound, "terms": terms,
            "bucket_reads": reads}


def roofline(s: RetrieveShape, hw: HW = H100) -> Dict[str, object]:
    """Fused-vs-unfused roofline record for one micro-batch shape.

    ``*_bound_fraction`` is bound/total: 1.0 means the path moves only
    the bytes the search fundamentally requires. Under ``H100`` the
    record adds the port kernels' traffic (``port_hbm_bytes``) where it
    differs: ``port_fused_bytes``, ``port_memory_s``, ``port_bucket_reads``.
    """
    fused = hbm_bytes(s, fused=True)
    unfused = hbm_bytes(s, fused=False)
    flops = 2.0 * s.nq * s.rows_scored * (
        s.pq_m if (s.index_type == "ivf" and s.quant == "pq") else s.d)
    out = {
        "shape": s,
        "flops": flops,
        "compute_s": flops / hw.peak_flops,
        "bound_bytes": fused["bound"],
        "fused_bytes": fused["total"],
        "unfused_bytes": unfused["total"],
        "fused_memory_s": fused["total"] / hw.hbm_bw,
        "unfused_memory_s": unfused["total"] / hw.hbm_bw,
        "fused_bound_fraction": fused["bound"] / fused["total"],
        "unfused_bound_fraction": unfused["bound"] / unfused["total"],
        "fused_terms": fused["terms"],
        "unfused_terms": unfused["terms"],
    }
    port = port_hbm_bytes(s) if hw == H100 else None
    if port is not None:
        out.update(port_fused_bytes=port["total"],
                   port_memory_s=port["total"] / hw.hbm_bw,
                   port_bucket_reads=port["bucket_reads"])
    return out
