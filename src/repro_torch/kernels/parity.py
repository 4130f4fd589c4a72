"""The parity rule for top-k results, shared by the tests and ``chip_smoke.py``.

Two fp32 top-k results of the same search (the port against the JAX package,
or a kernel against its plain version) sum their dot products in different
orders, so their scores differ in the last bits and near-tied entries may
swap. The rule:

* scores agree within ``TOL`` (1e-5; unit vectors, fp32) position by
  position;
* ids are equal, except inside a group of consecutive reference scores
  within ``TOL`` of each other (a near tie), where both results must hold
  the same set of ids; a group that reaches the last position is exempt
  from that, because its tie may continue past ``k``;
* no valid id repeats within a row.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

TOL = 1e-5


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def compare_topk(s_ref, i_ref, s, i, tol: float = TOL) -> Dict[str, float]:
    """Hold ``(s, i)`` against ``(s_ref, i_ref)`` (``[nq, k]`` each).

    Returns ``max_abs_diff`` (largest score difference), ``id_mismatches``
    (positions whose ids differ) and ``violations`` (rows breaking the rule
    above; 0 means the results agree).
    """
    s_ref, i_ref, s, i = (_np(x) for x in (s_ref, i_ref, s, i))
    if s_ref.shape != s.shape or i_ref.shape != i.shape:
        raise ValueError(f"shapes differ: {s_ref.shape} vs {s.shape}")
    diff = np.abs(s_ref.astype(np.float64) - s.astype(np.float64))
    violations = 0
    nq, k = s_ref.shape
    for r in range(nq):
        ok = bool((diff[r] <= tol).all())
        valid = i[r][i[r] >= 0]
        ok &= len(set(valid.tolist())) == len(valid)
        lo = 0
        while lo < k and ok:
            hi = lo + 1
            while hi < k and s_ref[r, hi - 1] - s_ref[r, hi] <= tol:
                hi += 1
            if hi < k:
                ok = (sorted(i_ref[r, lo:hi].tolist())
                      == sorted(i[r, lo:hi].tolist()))
            lo = hi
        violations += not ok
    return {"max_abs_diff": float(diff.max()) if diff.size else 0.0,
            "id_mismatches": int((i_ref != i).sum()),
            "violations": violations}
