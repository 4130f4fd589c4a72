"""Fused retrieve backend gate: parity, roofline bytes, latency (the port of
``benchmarks/fused_retrieve.py``).

Three halves, one claim (RAGO's stage-fusion argument: the retrieve hot
path should move only the bytes the search fundamentally requires):

* **Equivalence**: the ``use_kernel="fused"`` rung must equal the plain
  ``off`` rung on every index_type x quant config, both freshly built and
  after mutations (tombstones + fresh inserts in the hybrid buffer), under
  the port's parity rule (``repro_torch.kernels.parity``: ids equal outside
  near ties, |d score| <= 1e-5; bit-exactness is not the bar, as on the
  reference's own tree). The reference's two kernel modes become the two
  places the port runs (it dispatches by the inputs' device, with no mode
  variable): ``interpret`` (the reference's Pallas kernels) holds the DB
  on ``device``, where the fused rung launches the CUDA kernels
  (``topk_search``, ``ivf_topk``, ``sq8_topk``, ``pq_topk``) and ``off``
  runs plain tensor ops; ``xla`` (the reference's scan fallbacks) holds it
  on the CPU, both rungs through the kernels' plain versions. Both rungs
  search one built state: the reference builds two DBs from one draw, but
  on the card k-means sums with atomic adds, so two builds may differ in
  their last bits.
* **Roofline**: ``repro_torch.roofline.retrieve``'s byte model: the fused
  path must move strictly fewer HBM bytes than the unfused path and sit
  strictly closer to the bandwidth bound (``bound_fraction``) on every
  ladder config at serving scale.
* **Latency**: the micro-batch retrieve primitives timed head to head on
  ``device`` (host clock around a synchronised call, best of 3 after a
  warm-up). sq8: the ``op`` rung (the ``quant_score`` kernel, then one
  ``torch.topk`` over (score, row) keys) against ``sq8_topk``; PQ: the
  plain ``_pq_ivf_search`` (gather, LUT sum, one top-k) against
  ``pq_topk``, each side over its DB layout (int32 codes, the uint8 packed
  mirror). ``MIN_SPEEDUP`` gates the card's rows only: on the CPU both
  sides are the kernels' plain versions, which were never meant to be
  fast, so there the rows are printed and the gate is not applied.

``--check`` asserts all three; ``--smoke`` shrinks the corpora.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device, synchronize
from repro_torch.experiments.common import emit

MIN_SPEEDUP = 1.05        # fused must beat unfused by at least this (card)


def _corpus(n: int, dim: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    q = vecs[:: max(1, n // 16)][:12].copy()
    q += 0.02 * rng.standard_normal(q.shape).astype(np.float32)
    return vecs, q


CONFIGS = [("flat", "none"), ("flat", "sq8"), ("flat", "pq"),
           ("ivf", "none"), ("ivf", "sq8"), ("ivf", "pq")]


def modes(device) -> List[tuple]:
    """The reference's kernel modes as the port's devices."""
    return [("interpret", resolve_device(device)),
            ("xla", torch.device("cpu"))]


def make_db(index_type: str, quant: str, vecs: np.ndarray, device):
    """The gate's DB on the ``fused`` rung (its packed mirror built), with
    ``vecs`` inserted and indexed."""
    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB

    n, dim = vecs.shape
    db = TorchVectorDB(DBConfig(
        index_type=index_type, quant=quant, dim=dim, capacity=n + 64,
        nlist=8, nprobe=4, flat_capacity=64, pq_m=4, use_kernel="fused"),
        device=device)
    db.insert(vecs.copy(), [Chunk(chunk_id=-1, doc_id=i // 4, text=f"c{i}")
                            for i in range(n)])
    db.build_index()
    return db


def equivalence(n: int = 512, dim: int = 32, k: int = 8,
                device="cuda") -> List[Dict]:
    """Fused vs the plain ladder on one state, pre and post mutation."""
    from repro_torch.core.interfaces import Chunk
    from repro_torch.kernels.parity import compare_topk

    vecs, q = _corpus(n, dim)
    rng = np.random.default_rng(7)
    fresh = rng.standard_normal((12, dim)).astype(np.float32)
    rows: List[Dict] = []
    for mode, dev in modes(device):
        qt = torch.from_numpy(q).to(dev)
        for index_type, quant in CONFIGS:
            db = make_db(index_type, quant, vecs, dev)
            exact = {}
            for phase in ("built", "mutated"):
                if phase == "mutated":
                    db.remove(1)          # tombstones
                    db.remove(17)
                    db.insert(fresh.copy(),
                              [Chunk(chunk_id=-1, doc_id=9000 + i,
                                     text=f"f{i}")
                               for i in range(len(fresh))])
                sa, ia = db.search_arrays(qt, k, rung="off")
                sb, ib = db.search_arrays(qt, k)
                exact[phase] = float(
                    compare_topk(sa, ia, sb, ib)["violations"] == 0)
            rows.append({
                "bench": (f"fused_retrieve/equiv_{mode}_"
                          f"{index_type}_{quant}"),
                "mode": mode, "index_type": index_type, "quant": quant,
                "exact_built": exact["built"],
                "exact_mutated": exact["mutated"],
            })
    return rows


# serving-scale micro-batch shapes for the roofline byte model
ROOFLINE_SHAPES = [
    ("flat", "none", dict(nq=64, n=1 << 17, d=256, k=16)),
    ("flat", "sq8", dict(nq=64, n=1 << 17, d=256, k=16)),
    ("ivf", "none", dict(nq=64, n=1 << 20, d=256, k=16, nlist=256,
                         nprobe=16)),
    ("ivf", "pq", dict(nq=64, n=1 << 20, d=256, k=16, nlist=256,
                       nprobe=16, pq_m=8)),
]


def roofline_rows() -> List[Dict]:
    """The analytic HBM-bytes comparison (no hardware needed)."""
    from repro_torch.roofline.retrieve import RetrieveShape, roofline

    rows: List[Dict] = []
    for index_type, quant, kw in ROOFLINE_SHAPES:
        r = roofline(RetrieveShape(index_type=index_type, quant=quant, **kw))
        rows.append({
            "bench": f"fused_retrieve/roofline_{index_type}_{quant}",
            "index_type": index_type, "quant": quant,
            "bound_bytes": r["bound_bytes"],
            "fused_bytes": r["fused_bytes"],
            "unfused_bytes": r["unfused_bytes"],
            "fused_bound_fraction": r["fused_bound_fraction"],
            "unfused_bound_fraction": r["unfused_bound_fraction"],
            "bytes_saved_ratio": r["unfused_bytes"] / r["fused_bytes"],
        })
    return rows


def _time(fn, device: torch.device, reps: int = 3) -> float:
    fn()                                      # build + warm
    synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def latency(smoke: bool = False, device="cuda") -> List[Dict]:
    """Head-to-head micro-batch timing of the unfused and fused sides."""
    from repro_torch.core.vectordb import _pq_ivf_search, _sq8_flat_search
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    rng = np.random.default_rng(0)
    rows: List[Dict] = []
    # -- sq8 flat micro-batch ----------------------------------------------
    nq, n, d, k = (32, 1 << 15, 256, 16) if smoke else (64, 1 << 17, 256, 16)
    q = t(rng.standard_normal((nq, d)), torch.float32)
    codes = t(rng.integers(-127, 128, (n, d)), torch.int8)
    scale = t(rng.random(d) + 0.5, torch.float32)
    live = t(rng.random(n) < 0.95, torch.bool)
    t_un = _time(lambda: _sq8_flat_search(q, codes, scale, live, k, "op"),
                 dev)
    t_fu = _time(lambda: _sq8_flat_search(q, codes, scale, live, k,
                                          "fused"), dev)
    rows.append({
        "bench": "fused_retrieve/latency_sq8",
        "nq": nq, "n": n, "d": d, "k": k,
        "unfused_ms": t_un * 1e3, "fused_ms": t_fu * 1e3,
        "speedup": t_un / t_fu,
    })
    # -- pq ivf micro-batch ------------------------------------------------
    nq, d, k, m = (32, 256, 16, 8) if smoke else (64, 256, 16, 8)
    nlist, cap_b, nprobe = (32, 1024, 8) if smoke else (64, 4096, 16)
    q = t(rng.standard_normal((nq, d)), torch.float32)
    cent = t(rng.standard_normal((nlist, d)), torch.float32)
    codebook = t(rng.standard_normal((m, 256, d // m)), torch.float32)
    pcodes = t(rng.integers(0, 256, (nlist * cap_b, m)), torch.int32)
    pcodes_u8 = pcodes.to(torch.uint8)
    pslot = t(np.arange(nlist * cap_b, dtype=np.int32), torch.int32)
    pok = t(rng.random(nlist * cap_b) < 0.95, torch.bool)
    # unfused reference over the identical layout (buckets == packed rows,
    # so both paths score exactly the same candidates)
    buckets = pslot.view(nlist, cap_b)
    t_un = _time(lambda: _pq_ivf_search(
        q, pcodes, codebook, pok, cent, buckets, buckets >= 0, nprobe, k),
        dev)
    t_fu = _time(lambda: kops.pq_topk(q, codebook, cent, pcodes_u8, pslot,
                                      pok, nprobe, k), dev)
    rows.append({
        "bench": "fused_retrieve/latency_pq",
        "nq": nq, "nlist": nlist, "cap_b": cap_b, "nprobe": nprobe,
        "unfused_ms": t_un * 1e3, "fused_ms": t_fu * 1e3,
        "speedup": t_un / t_fu,
    })
    return rows


def run(scale: float = 1.0, device="cuda") -> List[Dict]:
    """``repro_torch.experiments.run`` entry point."""
    device = resolve_device(device)
    n = max(256, int(512 * scale))
    return (equivalence(n=n, device=device) + roofline_rows()
            + latency(smoke=scale < 1.0, device=device))


def check(rows: List[Dict], latency_gate: bool = True) -> List[str]:
    """The acceptance assertions over a finished sweep's rows (the latency
    gate only where ``latency_gate``: the card's rows)."""
    errs: List[str] = []
    for r in rows:
        b = r["bench"]
        if "/equiv_" in b:
            if r["exact_built"] != 1.0:
                errs.append(f"{b}: fused != reference on fresh index")
            if r["exact_mutated"] != 1.0:
                errs.append(f"{b}: fused != reference after mutations")
        elif "/roofline_" in b:
            if not r["fused_bytes"] < r["unfused_bytes"]:
                errs.append(f"{b}: fused moves {r['fused_bytes']:.3g}B, not "
                            f"less than unfused {r['unfused_bytes']:.3g}B")
            if not (r["fused_bound_fraction"]
                    > r["unfused_bound_fraction"]):
                errs.append(f"{b}: fused bound_fraction "
                            f"{r['fused_bound_fraction']:.3f} does not beat "
                            f"unfused {r['unfused_bound_fraction']:.3f}")
        elif "/latency_" in b and latency_gate:
            if r["speedup"] < MIN_SPEEDUP:
                errs.append(f"{b}: speedup {r['speedup']:.2f}x below "
                            f"{MIN_SPEEDUP}x")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized corpora and micro-batches")
    ap.add_argument("--check", action="store_true",
                    help="assert parity + roofline (+ latency on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        rows = (equivalence(n=384, device=device) + roofline_rows()
                + latency(smoke=True, device=device))
    else:
        rows = run(args.scale, device)
    emit([dict(r) for r in rows])
    if args.check:
        gate = device.type == "cuda"
        errs = check(rows, latency_gate=gate)
        if errs:
            print("CHECK FAILED:", "; ".join(errs))
            return 1
        print("CHECK OK: fused rung equal to off by the parity rule on all "
              f"{len(CONFIGS)} configs x 2 modes (incl. post-mutation), "
              "HBM bytes strictly closer to the bandwidth bound, "
              + (f"micro-batch speedup >= {MIN_SPEEDUP}x (sq8 + pq)" if gate
                 else "latency not gated on the CPU"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
