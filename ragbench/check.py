"""The correctness check: what the window's timed path produced, judged by
the plain reference (``ragbench.reference``) once the window has closed.

``capture`` takes from the program what the reference judges and follows
(an IVF index's centroids and bucket lists, and the DB's slot count)
before the program is freed; ``judge`` then rebuilds the DB's rows from
the seed and the recorded writes, replays the writes' order against each
judged search, and compares, on requests drawn from the seed and on the
searches aimed at rows the window inserted: the DB's lists, that those rows
are found, and for an IVF index its centroids (worked out again) and its
buckets.

With ``control=True`` it also reads each number for the control (the
reference one precision lower, TF32 for the fp32 scores, put in the
program's place).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ragbench import deploy
from ragbench.reference import search as RS
from ragbench.traffic.streams import rng_for

INF = float("inf")


def capture(dep) -> Dict[str, Any]:
    db = dep.db
    out = {"n_slots": int(db.n_slots), "nprobe": int(db.cfg.nprobe),
           "ivf": None}
    if db.cfg.index_type == "ivf" and db.centroids is not None:
        out["ivf"] = {
            "cent": db.centroids[:, :db.cfg.dim].float().cpu().numpy(),
            "buckets": db.buckets.cpu().numpy()}
    return out


def free(dep) -> None:
    """Drop the program's objects and its device memory."""
    import gc

    dep.db = None
    gc.collect()
    if dep.device.type == "cuda":
        torch.cuda.synchronize(dep.device)
        torch.cuda.empty_cache()


# -- the DB's rows and the order of its writes ---------------------------


class Store:
    """Every slot's row and the sequence numbers of its insert and removal
    (entry ``a``, exit ``b``; a slot never removed has ``rem_a = inf``)."""

    def __init__(self, dep, cap: Dict[str, Any], device):
        cfg, log = dep.cell.cfg, dep.log
        N = cap["n_slots"]
        dim = cfg["db"]["dim"]
        filler = deploy.draw_rows(cfg, dep.seed, device)
        vec = torch.zeros((N, dim), dtype=torch.float32, device=device)
        ins_a = np.full(N, INF)
        ins_b = np.full(N, INF)
        rem_a = np.full(N, INF)
        rem_b = np.full(N, INF)
        doc_slots: Dict[int, List[int]] = {}
        events = [("i", r["a"], r) for r in log.inserts] + \
            [("r", r["a"], r) for r in log.removes]
        for kind, _, r in sorted(events, key=lambda e: e[1]):
            if kind == "i":
                s = r["slots"]
                if r["rows"] is not None:
                    lo, hi = r["rows"]
                    vec[torch.as_tensor(s, device=device)] = filler[lo:hi]
                else:
                    vec[torch.as_tensor(s, device=device)] = torch.as_tensor(
                        r["vec"], device=device)
                ins_a[s], ins_b[s] = r["a"], r["b"]
                for slot, d in zip(s.tolist(), r["docs"].tolist()):
                    doc_slots.setdefault(d, []).append(slot)
            else:
                s = doc_slots.pop(r["doc"], [])
                rem_a[s], rem_b[s] = r["a"], r["b"]
        del filler
        self.vec, self.device = vec, device
        self.ins_a, self.ins_b, self.rem_a, self.rem_b = ins_a, ins_b, rem_a, \
            rem_b
        bs = dep.build_seq
        self.indexed = torch.as_tensor((ins_b < bs) & (rem_a > bs),
                                       device=device)

    def seen(self, a: int, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(visible, uncertain) for a search that ran from seq a to b."""
        vis = (self.ins_b < a) & (self.rem_a > b)
        gone = (self.ins_a > b) | (self.rem_b < a)
        dev = self.device
        return (torch.as_tensor(vis, device=dev),
                torch.as_tensor(~vis & ~gone, device=dev))


def _db_scored(dep, store: Store) -> torch.Tensor:
    """Each slot's row as the configuration scores it, float64: an indexed
    row's SQ8 reconstruction under SQ8, else the fp32 row."""
    vec64 = store.vec.double()
    if dep.cell.cfg["db"]["quant"] == "sq8":
        scale, codes = RS.sq8(store.vec, store.indexed)
        vec64[store.indexed] = (codes[store.indexed].double()
                                * scale.double())
    return vec64


def _ivf_info(dep, cap, store: Store) -> Optional[Dict[str, Any]]:
    if cap["ivf"] is None:
        return None
    dev = store.device
    buckets = torch.as_tensor(cap["ivf"]["buckets"], device=dev).long()
    N = store.vec.shape[0]
    list_of = torch.full((N,), -1, dtype=torch.long, device=dev)
    lists = torch.arange(buckets.shape[0], device=dev)[:, None].expand_as(
        buckets)
    ok = buckets >= 0
    list_of[buckets[ok]] = lists[ok]
    times = torch.bincount(buckets[ok], minlength=N)
    return {"cent64": torch.as_tensor(cap["ivf"]["cent"],
                                      device=dev).double(),
            "list_of": list_of, "indexed": store.indexed,
            "nprobe": cap["nprobe"], "fill": ok.sum(1),
            "cap_b": buckets.shape[1], "twice": int((times > 1).sum())}


def lists(rec: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A search record's ``(ids, scores)`` as ``[nq, k]`` tensors."""
    if rec.get("res") is not None:
        compact(rec)
    return torch.as_tensor(rec["ids"]), torch.as_tensor(rec["scores"])


def compact(rec: Dict[str, Any]) -> None:
    """Fold a search record's result objects into two arrays."""
    res = rec.pop("res")
    rec["ids"] = np.stack([np.asarray(r.chunk_ids) for r in res]).astype(
        np.int64)
    rec["scores"] = np.stack([np.asarray(r.scores) for r in res]).astype(
        np.float64)
    rec["res"] = None


def _max(vals, key):
    xs = [v[key] for v in vals]
    return max(xs) if xs else 0.0


def judge_db(dep, cap, store: Store, searches: List[Dict[str, Any]],
             control: bool) -> Tuple[Dict[str, float], Dict[str, float]]:
    vec64 = _db_scored(dep, store)
    ivf = _ivf_info(dep, cap, store)
    vec32 = vec64.float() if control else None
    prog, ctl = [], []
    k = None
    for s in searches:
        ids, sc = lists(s)
        k = ids.shape[1]
        q = torch.as_tensor(np.asarray(s["q"], dtype=np.float32))
        vis, unc = store.seen(s["a"], s["b"])
        prog.append(RS.judge(q, ids, sc, vec64, vis, unc, ivf))
        if control:
            ci, cs = RS.control_lists(q, vec32, vis, k, RS.to_tf32, ivf)
            ctl.append(RS.judge(q, ci.cpu(), cs.double().cpu(), vec64, vis,
                                torch.zeros_like(unc), ivf))
    nums = {"db_invalid": float(sum(p["invalid"] for p in prog)),
            "db_rank_gap": _max(prog, "rank_gap"),
            "db_score_err": _max(prog, "score_err"),
            "db_miss_share": _max(prog, "miss")}
    cnums = {}
    if control:
        cnums = {"db_invalid": float(sum(p["invalid"] for p in ctl)),
                 "db_rank_gap": _max(ctl, "rank_gap"),
                 "db_score_err": _max(ctl, "score_err"),
                 "db_miss_share": _max(ctl, "miss")}
    if ivf is not None:
        rows64 = store.vec.double()
        nums["bucket_misplaced"] = float(ivf["twice"] + RS.check_buckets(
            rows64, store.indexed, ivf["cent64"], ivf["list_of"], ivf["fill"],
            ivf["cap_b"]))
        a, b = judge_centroids(dep, store, ivf["cent64"], control)
        nums.update(a)
        cnums.update(b)
    return nums, cnums


def judge_centroids(dep, store: Store, cent64: torch.Tensor, control: bool
                    ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The program's centroids against the reference's, worked out again
    from the rows live at the build by the configuration's k-means: the
    objective's shortfall over the training sample, as a share of the
    reference's (``kmeans_objective_gap``, compared), and the median
    centroid's distance from its counterpart (``kmeans_centroid_median``, a
    reading)."""
    db = dep.cell.cfg["db"]
    live = torch.nonzero(store.indexed)[:, 0].cpu().numpy()
    sample, init = RS.kmeans_sample(live, db["train_sample"], db["nlist"])
    x64 = store.vec[torch.as_tensor(sample, device=store.device)].double()
    ref = RS.kmeans(x64, init, db["kmeans_iters"])
    best = RS.objective(x64, ref)

    def numbers(cent):
        return {"kmeans_objective_gap":
                (best - RS.objective(x64, cent)) / abs(best),
                "kmeans_centroid_median":
                float((cent - ref).norm(dim=1).median())}

    prog = numbers(cent64)
    ctl = {}
    if control:
        ctl = numbers(RS.kmeans(x64, init, db["kmeans_iters"],
                                RS.to_tf32).double())
    return prog, ctl


def _merge(into: Dict[str, float], new: Dict[str, float]) -> None:
    """Fold one judged part in: counts add up, every other number keeps
    its worst."""
    for k, v in new.items():
        add = k in COUNTS
        into[k] = into.get(k, 0.0) + v if add else max(into.get(k, 0.0), v)


COUNTS = ("db_invalid",)


def judge_search(dep, cap, win, control: bool):
    mix, seed = dep.cell.mix, dep.seed
    done = [r for r in win.requests if r["op"] == "search" and r["ok"]
            and r["end"] <= win.t1]
    if not done:
        return {"requests_judged": 0.0}, {}
    rng = rng_for(seed, "check")
    n = mix["check"]["requests"]
    pick = set(rng.choice(len(done), size=min(n, len(done)),
                          replace=False).tolist())
    fresh = [i for i, r in enumerate(done) if "fresh" in r]
    if fresh:
        pick |= set(rng.choice(fresh, size=min(n, len(fresh)),
                               replace=False).tolist())
    chosen = [done[i] for i in sorted(pick)]
    store = Store(dep, cap, dep.device)
    nums, cnums = judge_db(dep, cap, store, [r["search"] for r in chosen],
                           control)
    missed = 0
    for r in chosen:
        if "fresh" in r:
            ids, _ = lists(r["search"])
            for j, slot in enumerate(r["fresh"]):
                missed += int(slot not in ids[j].tolist())
    nums["fresh_missed"] = float(missed)
    nums["requests_judged"] = float(len(chosen))
    return nums, cnums


def judge(dep, cap, win, control: bool = False):
    with RS.fp32_matmul():
        return judge_search(dep, cap, win, control)


def verdict(nums: Dict[str, float], limits: Dict[str, Any]
            ) -> Tuple[bool, Dict[str, Dict[str, Optional[float]]]]:
    """Each limited number beside its limit; correct when every one is at
    or under its limit and something was judged."""
    out: Dict[str, Dict[str, Optional[float]]] = {}
    ok = bool(nums.get("requests_judged", 0))
    for name, lim in limits.items():
        val = nums.get(name)
        limit = lim.get("limit") if isinstance(lim, dict) else lim
        out[name] = {"value": val, "limit": limit}
        if val is None or limit is None or not val <= limit:
            ok = False
    return ok, out
