"""The parity rules for top-k results and for greedy tokens, shared by the
tests and ``chip_smoke.py``.

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

Greedy decoding (``compare_tokens``) follows the same idea: over 100k-wide
bf16 logits the top two can tie exactly, and two correct implementations
may then pick different tokens. Tokens must be equal, except from the first
position where the reference's own top-2 logit gap is within the logit
tolerance: there the pick may differ, and everything after it follows from a
different input.
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


def compare_tokens(ref_ids, ids, ref_gaps, tol: float) -> Dict[str, int]:
    """Hold greedy tokens ``ids [n, T]`` against ``ref_ids [n, T]``.

    ``ref_gaps [n, T]`` is the reference's top-1 minus top-2 logit at each
    step. A row agrees if its tokens equal the reference's up to the first
    position where they differ and the reference's gap there is at most
    ``tol``. Returns ``mismatch_rows`` (rows that differ anywhere) and
    ``violations`` (rows breaking the rule; 0 means they agree)."""
    ref_ids, ids, ref_gaps = (_np(x) for x in (ref_ids, ids, ref_gaps))
    if ref_ids.shape != ids.shape or ref_gaps.shape != ids.shape:
        raise ValueError(f"shapes differ: {ref_ids.shape}, {ids.shape}, "
                         f"{ref_gaps.shape}")
    mismatch = violations = 0
    for r in range(ids.shape[0]):
        diff = np.nonzero(ref_ids[r] != ids[r])[0]
        if len(diff):
            mismatch += 1
            violations += not ref_gaps[r, diff[0]] <= tol
    return {"mismatch_rows": mismatch, "violations": violations}
