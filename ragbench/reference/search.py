"""Plain top-k search, the judge of the vector DB's answers.

Scores are float64 inner products of the query as the DB received it with
each row as the configuration scores it: the fp32 row, or under SQ8 the
row's codes times the scale, both worked out again here from the rows
(``sq8``). A returned list is judged against the reference's own top-k
over the rows it could see:

* ``invalid``: ids that are no row it could see, repeated ids, or a short
  list where more rows were there (an exact count);
* ``rank_gap``: the largest amount by which a returned row at rank r
  scores below the reference's r-th best (near ties read ~1e-7);
* ``score_err``: the largest difference between a returned score and the
  reference's score of that row.

* ``miss``: the share of the exact top-k over every row it could see,
  the IVF's probes aside, that the list leaves out (a reading: an IVF
  index's recall falls short of 1 by its nature).

For an IVF index the rows it could see are the indexed rows of its probed
buckets (the reference's top ``nprobe`` centroids; lists within ``TIE`` of
the last one count as probed where the returned ids come from them) and
the fresh rows. The centroids and the bucket lists are the program's
state. The reference works the centroids out again (``kmeans``, the
configuration's rule, in float64) and holds the program's to them by the
k-means objective over the training sample (``objective``); it checks that
every indexed row lies in its nearest centroid's bucket
(``check_buckets``); then it follows the program's centroids.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

TIE = 1e-5
BIG = 1e300


@contextlib.contextmanager
def fp32_matmul():
    """Float32 products with TF32 off, restored on exit."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits (to nearest, ties even)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def kmeans_sample(live_slots: np.ndarray, train_sample: int,
                  nlist: int) -> tuple:
    """The configuration's training rows and starting centroids: the live
    slots at the build (ascending), ``train_sample`` of them drawn by numpy's
    ``default_rng(0)`` without replacement where there are more; then the
    first ``nlist`` of torch's CPU ``Generator(0)`` permutation of those."""
    sample = live_slots
    if len(live_slots) > train_sample:
        sample = np.random.default_rng(0).choice(live_slots, train_sample,
                                                 replace=False)
    gen = torch.Generator().manual_seed(0)
    n = len(sample)
    init = (torch.randint(n, (nlist,), generator=gen) if n < nlist
            else torch.randperm(n, generator=gen)[:nlist])
    return sample, init


def kmeans(x: torch.Tensor, init: torch.Tensor, iters: int,
           lower: Optional[Callable] = None) -> torch.Tensor:
    """Lloyd's spherical k-means from the rows ``init`` of ``x``: each
    round assigns every row to its best-scoring centroid by inner product,
    and moves each centroid with rows to their mean, renormalised. Float64;
    with ``lower``, the scores' operands in that precision, in fp32 (the
    control)."""
    cent = x[init.to(x.device)].clone()
    k = cent.shape[0]
    for _ in range(iters):
        if lower is None:
            a = (x @ cent.T).argmax(1)
        else:
            a = (lower(x.float()) @ lower(cent.float()).T).argmax(1)
        sums = torch.zeros_like(cent).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)[:, None]
        new = torch.where(counts > 0, sums / counts.clamp(min=1), cent)
        cent = new / (torch.linalg.norm(new, dim=1, keepdim=True) + 1e-9)
    return cent


def objective(x64: torch.Tensor, cent64: torch.Tensor) -> float:
    """The spherical k-means objective: the mean over the rows of the
    inner product with their best-scoring centroid (higher is better)."""
    return float((x64 @ cent64.T).max(1).values.mean())


def sq8(rows: torch.Tensor, live: torch.Tensor):
    """Per-dimension scale ``max |x| / 127 + 1e-12`` over the ``live`` rows
    and codes ``clamp(round(x / scale), -127, 127)`` of every row (fp32
    arithmetic, as the configuration states it)."""
    amax = torch.zeros(rows.shape[1], dtype=torch.float32, device=rows.device)
    idx = torch.nonzero(live)[:, 0]
    for lo in range(0, len(idx), 65536):
        amax = torch.maximum(amax, rows[idx[lo:lo + 65536]].abs().amax(0))
    scale = amax / 127.0 + 1e-12
    codes = torch.empty(rows.shape, dtype=torch.int8, device=rows.device)
    for lo in range(0, rows.shape[0], 65536):
        codes[lo:lo + 65536] = torch.round(rows[lo:lo + 65536] / scale).clamp(
            -127, 127).to(torch.int8)
    return scale, codes


def check_buckets(rows64: torch.Tensor, indexed: torch.Tensor,
                  cent64: torch.Tensor, list_of: torch.Tensor,
                  fill: torch.Tensor, cap_b: int) -> int:
    """Indexed rows whose bucket is wrong: not in exactly one bucket, or in
    one other than its nearest centroid's (within ``TIE``) while that one
    had room."""
    bad = int((indexed & (list_of < 0)).sum())
    idx = torch.nonzero(indexed & (list_of >= 0))[:, 0]
    for lo in range(0, len(idx), 65536):
        r = idx[lo:lo + 65536]
        s = rows64[r] @ cent64.T
        best = s.max(1).values
        mine = s.gather(1, list_of[r][:, None])[:, 0]
        full = fill[s.argmax(1)] >= cap_b
        bad += int(((mine < best - TIE) & ~full).sum())
    return bad


def judge(q: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor,
          vec64: torch.Tensor, visible: torch.Tensor,
          uncertain: torch.Tensor, ivf: Optional[Dict] = None
          ) -> Dict[str, float]:
    """Judge one request's lists ``ids``/``scores [nq, k]`` for queries
    ``q [nq, d]``. ``visible``: rows live throughout the search;
    ``uncertain``: rows written or removed while it ran (seen or not).
    ``ivf``: ``{"cent64", "list_of", "indexed", "nprobe"}``."""
    nq, k = ids.shape
    dev = vec64.device
    q64 = q.to(dev, torch.float64)
    s = q64 @ vec64.T                                          # [nq, N]
    ids = ids.to(dev).long()
    N = vec64.shape[0]
    safe = ids.clamp(0, N - 1)
    returned = torch.zeros((nq, N), dtype=torch.bool, device=dev)
    returned.scatter_(1, safe, ids >= 0)
    seen = visible[None, :] | (uncertain[None, :] & returned)
    exact = torch.where(seen, s, torch.tensor(-BIG, dtype=s.dtype,
                                              device=dev)).topk(k, dim=1)
    want = exact.values > -BIG / 2
    miss = float((want & ~returned.gather(1, exact.indices)).sum()
                 / max(int(want.sum()), 1))
    if ivf is not None:
        cs = q64 @ ivf["cent64"].T                             # [nq, nlist]
        nprobe = ivf["nprobe"]
        last = cs.topk(nprobe, dim=1).values[:, -1:]
        sure = cs > last + TIE
        tied = (cs - last).abs() <= TIE
        lists = ivf["list_of"]
        hit = torch.zeros_like(cs, dtype=torch.bool)
        ret_lists = lists[safe].clamp(min=0)
        hit.scatter_(1, ret_lists, (ids >= 0) & (lists[safe] >= 0))
        need = nprobe - sure.sum(1, keepdim=True)
        take_all = tied.sum(1, keepdim=True) <= need
        probed = sure | (tied & (take_all | hit))
        main = ivf["indexed"][None, :]
        in_probed = probed.gather(1, lists.clamp(min=0)[None, :].expand(nq, N))
        seen = seen & (~main | (in_probed & (lists >= 0)[None, :]))
    ref = torch.where(seen, s, torch.tensor(-BIG, dtype=s.dtype, device=dev))
    top = ref.topk(k, dim=1).values                            # [nq, k]
    has = top > -BIG / 2
    got = ids >= 0
    ok_id = seen.gather(1, safe) & got
    dup = (returned.sum(1) < got.sum(1))
    invalid = int((got & ~ok_id).sum()) + int((has & ~got).sum()) \
        + int(dup.sum())
    mine = s.gather(1, safe)
    both = got & ok_id & has
    gap = torch.where(both, top - mine, torch.zeros_like(mine))
    err = torch.where(both, (scores.to(dev, torch.float64) - mine).abs(),
                      torch.zeros_like(mine))
    return {"invalid": invalid, "rank_gap": float(gap.max()),
            "score_err": float(err.max()), "miss": miss}


def control_lists(q: torch.Tensor, vec: torch.Tensor, visible: torch.Tensor,
                  k: int, lower, ivf: Optional[Dict] = None):
    """The control's answer: the same search (for IVF its own ``nprobe``
    probes) over the visible rows with every product's operands in
    ``lower`` precision (``reference.model.to_tf32``), in fp32."""
    qx = lower(q.to(vec.device, torch.float32))
    s = qx @ lower(vec).T
    cand = visible[None, :].expand_as(s)
    if ivf is not None:
        cs = qx @ lower(ivf["cent64"].float()).T
        probed = torch.zeros_like(cs, dtype=torch.bool)
        probed.scatter_(1, cs.topk(ivf["nprobe"], dim=1).indices, True)
        lists = ivf["list_of"]
        inp = probed.gather(1, lists.clamp(min=0)[None, :].expand_as(s))
        cand = cand & (~ivf["indexed"][None, :]
                       | (inp & (lists >= 0)[None, :]))
    s = torch.where(cand, s, torch.tensor(float("-inf"), device=vec.device))
    top = s.topk(k, dim=1)
    return top.indices, top.values
