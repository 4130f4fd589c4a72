"""Peaks, the roofline bound and the work counts of the measured kernels
(see the package docstring for where each was copied from)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

F32 = 4
I32 = 4
I8 = 1


@dataclass(frozen=True)
class HW:
    peak_flops: float                  # bf16 tensor operations a second
    hbm_bw: float                      # device-memory bytes a second
    link_bw: float                     # bytes a second per link, each way
    fp32_flops: Optional[float] = None  # fp32 FMA operations a second
    int8_ops: Optional[float] = None    # int8 tensor operations a second


# NVIDIA H100 SXM (data sheet, dense, without sparsity, at 700 W): 3.35 TB/s
# HBM3; 989 TFLOP/s bf16 and 1,979 TOP/s int8 on the tensor cores, 67
# TFLOP/s fp32 outside them; NVLink 450 GB/s each way.
H100 = HW(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
          fp32_flops=67e12, int8_ops=1979e12)


def bound(n_bytes: float, n_flop: float, peak: Optional[float] = None,
          hw: HW = H100) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time ``hw`` takes to
    move ``n_bytes`` and do ``n_flop`` operations at ``peak`` a second
    (default: the bf16 tensor peak)."""
    t_bytes = n_bytes / hw.hbm_bw
    t_ops = n_flop / (hw.peak_flops if peak is None else peak)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _io_bytes(nq: int, d: int, k: int) -> float:
    """Queries read, ``(score, id)`` lists written."""
    return nq * d * F32 + nq * k * (F32 + I32)


def ivf_topk_cost(nq: int, d: int, k: int, nlist: int, probed_rows: int,
                  pair_rows: int) -> Dict[str, float]:
    """One IVF search over fp32 rows: the centroids and the live rows of the
    distinct probed buckets (``probed_rows``) read once, plus queries and
    outputs; operations: the centroid scan and each query's scan of its
    own probed buckets' live rows (``pair_rows`` summed over the (query,
    probe) pairs), at the fp32 rate."""
    n_bytes = probed_rows * d * F32 + nlist * d * F32 + _io_bytes(nq, d, k)
    flops = 2.0 * nq * nlist * d + 2.0 * pair_rows * d
    return {"bytes": n_bytes, "flops": flops, "peak": H100.fp32_flops}


def sq8_topk_cost(nq: int, d: int, k: int, live_rows: int
                  ) -> Dict[str, float]:
    """One flat SQ8 search: every live row's int8 codes and the scale read
    once, plus queries and outputs; an int8 product per code and query."""
    n_bytes = live_rows * d * I8 + d * F32 + _io_bytes(nq, d, k)
    flops = 2.0 * nq * live_rows * d
    return {"bytes": n_bytes, "flops": flops, "peak": H100.int8_ops}


def topk_search_cost(nq: int, d: int, k: int, live_rows: int
                     ) -> Dict[str, float]:
    """One exact fp32 scan (the freshness buffer's): the rows it must score
    read once, plus queries and outputs, at the fp32 rate."""
    n_bytes = live_rows * d * F32 + _io_bytes(nq, d, k)
    flops = 2.0 * nq * live_rows * d
    return {"bytes": n_bytes, "flops": flops, "peak": H100.fp32_flops}


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile, q in [0, 100] (numpy's default)."""
    if not len(xs):
        return 0.0
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac
