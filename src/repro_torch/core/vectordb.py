"""PyTorch vector database: the port of ``repro.core.vectordb`` (paper §3.3.2).

Index families: Flat (exact scan) and IVF (k-means partitions, ``nprobe``
probing, fixed-capacity buckets), each with ``quant`` none, sq8 (int8 codes
and a per-dimension scale) or pq (``pq_m`` subspaces of 256 k-means codes
each). Inserts land in a hybrid flat freshness buffer that queries scan
alongside the main index until ``_maybe_rebuild`` folds it in; removals are
tombstones until the next rebuild.

The quantized variants keep the reference's behaviour, quirks included:
codes are made only at ``build_index`` (rows inserted later keep code 0
until the next rebuild); the main index searches sq8 codes only on a flat
index and PQ codes only on IVF (IVF + sq8 and flat + pq train codes but
search the fp32 vectors); the freshness buffer and the cold start always
scan the fp32 vectors.

State lives where it is used: the corpus ``vectors``, the centroids, the
buckets, the codes, scale and codebook, and the bucket-contiguous packed
mirror stay on the device (inserted rows are copied in under the lock, so a
search never re-uploads the corpus); payloads, id maps and the
``live``/``indexed`` bit masks are host-side bookkeeping, copied per search
snapshot and uploaded as masks. The device rows are ``width`` wide: ``dim``
rounded up to a multiple of 4 (the list kernels read 16-byte units), with
zero columns past ``dim`` in the vectors, the centroids, the packed mirror
and the SQ8 codes, and scale 0 there; a search pads its queries once. A
zero column changes no inner product, so this is the unpadded search.

The ``use_kernel`` ladder picks how the search runs. ``off`` is the plain
ladder the kernel rungs are held against: plain tensor ops throughout. The
reference's ``off`` rung already calls ``quant_score`` for flat + sq8; the
port routes it to the plain version on purpose (both compute the same
function), so that ``off`` runs no kernel. ``op`` sends flat scans through
the ``topk_search`` kernel and flat + sq8 through the ``quant_score``
kernel (then one ``torch.topk`` over (score, row) keys, the stable
top-k's order); ``fused`` sends flat + sq8 through
``sq8_topk`` and the IVF main index through ``ivf_topk`` (fp32 rows) or
``pq_topk`` (PQ codes) over the packed mirror. IVF + pq on ``off``/``op``
is the plain ``_pq_ivf_search``. On CPU tensors every rung runs the
kernels' plain versions (``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.interfaces import Chunk, DBInstance, SearchResult
from repro_torch.core.registry import register
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import topk_search as kts
from repro_torch.kernels.ref import NEG, pad_cols, padded_width, stable_topk
from repro_torch.obs.tracer import Phases, active_tracer

KERNEL_LADDER = ("off", "op", "fused")
QUANTS = ("none", "sq8", "pq")

# rows per centroid-assignment product: [ASSIGN_CHUNK, nlist] scores at a
# time instead of one [n, nlist] matrix (4 GB at 1M rows x 1024 lists)
ASSIGN_CHUNK = 65536


def kernel_ladder(use_kernel) -> str:
    """Normalize the ``use_kernel`` config value to a ladder rung.

    Accepts the legacy booleans (``False`` -> ``off``, ``True`` -> ``op``)
    and the string rungs; anything else raises naming the allowed values.
    """
    if use_kernel is None or use_kernel is False:
        return "off"
    if use_kernel is True:
        return "op"
    if use_kernel in KERNEL_LADDER:
        return use_kernel
    raise ValueError(
        f"invalid use_kernel={use_kernel!r}; allowed values: "
        f"False/True or {', '.join(KERNEL_LADDER)}")


# ---------------------------------------------------------------------------
# k-means (IVF training)
# ---------------------------------------------------------------------------


def assign(x: torch.Tensor, cent: torch.Tensor,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest centroid (max inner product, first on ties) of ``x[rows]``
    (all of ``x`` when ``rows`` is None), ``ASSIGN_CHUNK`` rows at a time."""
    n = x.shape[0] if rows is None else rows.shape[0]
    out = torch.empty(n, dtype=torch.long, device=x.device)
    for lo in range(0, n, ASSIGN_CHUNK):
        xs = (x[lo:lo + ASSIGN_CHUNK] if rows is None
              else x[rows[lo:lo + ASSIGN_CHUNK]])
        out[lo:lo + ASSIGN_CHUNK] = (xs @ cent.T).argmax(1)
    return out


def kmeans(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0,
           init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lloyd's k-means on x's device; returns [k, dim] unit centroids.

    The initial centroids are ``k`` rows drawn with a ``torch.Generator``
    (with replacement only when ``n < k``), or ``init``. The JAX package
    draws with ``jax.random.choice``, which torch cannot reproduce, so a
    parity run passes the reference's draw as ``init``. The update sums
    each cluster with ``index_add_`` over the assignments.
    """
    n = x.shape[0]
    if init is None:
        gen = torch.Generator().manual_seed(seed)
        idx = (torch.randint(n, (k,), generator=gen) if n < k
               else torch.randperm(n, generator=gen)[:k])
        cent = x[idx.to(x.device)]
    else:
        cent = init.to(device=x.device, dtype=x.dtype).clone()
    for _ in range(iters):
        a = assign(x, cent)
        sums = torch.zeros_like(cent).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)[:, None]
        new = torch.where(counts > 0, sums / counts.clamp(min=1), cent)
        cent = new / (torch.linalg.norm(new, dim=1, keepdim=True) + 1e-9)
    return cent


def fill_buckets(slots: torch.Tensor, asg: torch.Tensor, nlist: int,
                 cap_b: int) -> Tuple[torch.Tensor, int]:
    """Lay ``slots`` (increasing) into ``[nlist, cap_b]`` buckets by their
    assignment ``asg``, -1 padded; returns ``(buckets, overflow)``.

    The rule is the reference's: in slot order, a row whose bucket is full
    spills to the globally least-full bucket, and a row that finds every
    bucket full overflows. Without a full bucket that is a stable sort by
    bucket, done on the device; with one, the sequential rule runs on the
    host.
    """
    dev = slots.device
    counts = torch.bincount(asg, minlength=nlist)
    if int(counts.max()) <= cap_b:
        order = torch.sort(asg, stable=True)[1]
        b = asg[order]
        start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(order.shape[0], device=dev) - start[b]
        buckets = torch.full((nlist, cap_b), -1, dtype=torch.int32,
                             device=dev)
        buckets[b, pos] = slots[order].int()
        return buckets, 0
    buckets_np = np.full((nlist, cap_b), -1, dtype=np.int32)
    fill = np.zeros(nlist, dtype=np.int64)
    overflow = 0
    for slot, b in zip(slots.cpu().numpy(), asg.cpu().numpy()):
        if fill[b] < cap_b:
            buckets_np[b, fill[b]] = slot
            fill[b] += 1
        else:
            b2 = int(np.argmin(fill))
            if fill[b2] < cap_b:
                buckets_np[b2, fill[b2]] = slot
                fill[b2] += 1
            else:
                overflow += 1
    return torch.from_numpy(buckets_np).to(dev), overflow


# ---------------------------------------------------------------------------
# search primitives
# ---------------------------------------------------------------------------


def _flat_search(q, vecs, live, k: int, rung: str = "off"):
    """Exact search. q:[nq,d] vecs:[cap,d] live:[cap] bool -> [nq,k]
    ``(scores, idx)`` with ``(NEG, -1)`` padding; ``op``/``fused`` go
    through the ``topk_search`` kernel."""
    if rung == "off":
        return kref.topk_search(q, vecs, live, k)
    return kops.topk_search(q, vecs, live, k)


def _ivf_search(q, vecs, live, cent, buckets, bucket_live, nprobe: int,
                k: int):
    """Unfused IVF: probe ``nprobe`` buckets per query, gather and score
    their members, one top-k over ``[nq, nprobe*cap_b]``."""
    nq = q.shape[0]
    probe = kref.probe(q, cent, nprobe).long()           # [nq, nprobe]
    cand = buckets[probe]                                 # [nq, np, cap_b]
    cand_safe = cand.clamp(min=0).long()
    ok = bucket_live[probe] & (cand >= 0) & live[cand_safe]
    scores = torch.einsum("qd,qpbd->qpb", q, vecs[cand_safe])
    scores = torch.where(ok, scores, torch.tensor(NEG, device=q.device))
    return kref.merge_candidates(scores.reshape(nq, -1),
                                 cand_safe.reshape(nq, -1).int(), k)


def _sq8_flat_search(q, codes, scale, live, k: int, rung: str = "off"):
    """Scalar-quantized exact search. codes:[cap,d] int8, scale:[d],
    live:[cap] bool -> [nq,k] ``(scores, idx)`` with ``(NEG, -1)`` padding.

    ``off`` and ``op`` score the whole corpus (``[nq, cap]``): ``off``
    with the plain ``quant_score`` and a stable top-k, ``op`` with its
    kernel and one ``torch.topk`` over (score, row) keys
    (``select_by_row``), in the same order; ``fused`` selects inside the
    ``sq8_topk`` kernel.
    """
    if rung == "fused":
        return kops.sq8_topk(q, codes, scale, live, k)
    if rung == "op":
        return kts.select_by_row(kops.quant_score(q, codes, scale), live, k)
    return kref.masked_topk(kref.quant_score(q, codes, scale), live, k)


def _pq_ivf_search(q, codes, codebook, live, cent, buckets, bucket_live,
                   nprobe: int, k: int):
    """Unfused PQ asymmetric-distance search inside the probed buckets.

    codes:[cap,m] int32 in [0,256); codebook:[m,256,dsub]. Gathers every
    probed member's codes (``[nq, nprobe, cap_b, m]``), sums its LUT
    entries with ``sum(-1)`` as the reference does, one top-k over
    ``[nq, nprobe*cap_b]``.
    """
    nq = q.shape[0]
    m = codebook.shape[0]
    flat_lut = kref.pq_lut(q, codebook).reshape(nq, m * 256)
    probe = kref.probe(q, cent, nprobe).long()           # [nq, nprobe]
    cand = buckets[probe]                                 # [nq, np, cap_b]
    cand_safe = cand.clamp(min=0).long()
    ok = bucket_live[probe] & (cand >= 0) & live[cand_safe]
    offs = torch.arange(m, device=q.device) * 256
    fidx = (codes[cand_safe].long() + offs).reshape(nq, -1)
    scores = torch.gather(flat_lut, 1, fidx).view(*cand.shape, m).sum(-1)
    scores = torch.where(ok, scores, torch.tensor(NEG, device=q.device))
    return kref.merge_candidates(scores.reshape(nq, -1),
                                 cand_safe.reshape(nq, -1).int(), k)


def merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two top-k lists (hybrid main + flat freshness buffer) into one,
    by descending score, ``a`` first on equal scores.

    The two lists never share an id: the main index holds the ``live &
    indexed`` slots and the buffer the ``live & ~indexed`` ones. So, unlike
    the reference, which also merges the shards of a sharded DB, there is
    nothing to deduplicate and the merge stays on the device. Rows with
    fewer than ``k`` valid ids keep their ``(NEG, -1)`` padding.
    """
    scores = torch.cat([scores_a, scores_b], dim=1)
    idx = torch.cat([idx_a, idx_b], dim=1)
    top, pos = stable_topk(scores, k)
    return top, torch.gather(idx, 1, pos)


# ---------------------------------------------------------------------------
# the database
# ---------------------------------------------------------------------------


@dataclass
class DBConfig:
    index_type: str = "ivf"          # flat | ivf
    quant: str = "none"              # none | sq8 | pq
    dim: int = 384
    capacity: int = 1 << 16
    nlist: int = 64
    nprobe: int = 8
    bucket_cap: int = 0              # 0 -> auto: 4 * capacity / nlist
    pq_m: int = 8                    # PQ subspaces
    kmeans_iters: int = 8
    use_hybrid: bool = True          # temp flat buffer for fresh inserts
    flat_capacity: int = 4096
    rebuild_threshold: float = 0.75  # rebuild when flat buffer this full
    # kernel ladder rung: False/"off" | True/"op" | "fused" (see KERNEL_LADDER)
    use_kernel: object = False
    train_sample: int = 16384


class TorchVectorDB(DBInstance):
    """Flat/IVF x {none, sq8, pq} vector DB with hybrid updates, on
    ``device`` (None: cuda).

    Thread-safety contract (as the reference's): all mutations
    (insert/remove/update/build_index/load_state) serialize on one
    reentrant lock, and ``search`` snapshots every piece of index state it
    needs under that lock before computing outside it. Writers only (a) fill
    slots that are not yet live, (b) flip ``live``/``indexed`` bits, or (c)
    swap whole index tensors, so a search sees a consistent, possibly
    slightly stale, view.
    """

    def __init__(self, cfg: DBConfig, device=None):
        if cfg.quant not in QUANTS:
            raise ValueError(f"quant must be one of {', '.join(QUANTS)}, "
                             f"got {cfg.quant!r}")
        if cfg.quant == "pq" and cfg.dim % cfg.pq_m:
            raise ValueError(f"dim={cfg.dim} is not a multiple of "
                             f"pq_m={cfg.pq_m}")
        if cfg.index_type not in ("flat", "ivf"):
            raise ValueError(f"index_type must be flat or ivf, got "
                             f"{cfg.index_type!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._kernel = kernel_ladder(cfg.use_kernel)  # validated ladder rung
        self._mu = threading.RLock()   # serializes mutations vs snapshots
        cap = cfg.capacity
        self.width = padded_width(cfg.dim)   # device row width
        self.vectors = torch.zeros((cap, self.width), dtype=torch.float32,
                                   device=self.device)   # guarded-by: _mu
        self.live = np.zeros((cap,), dtype=bool)         # guarded-by: _mu
        self.n_slots = 0                       # guarded-by: _mu
        self.chunks: Dict[int, Chunk] = {}     # guarded-by: _mu
        self.doc_slots: Dict[int, List[int]] = {}   # guarded-by: _mu
        # main-index state (device tensors)
        self.centroids: Optional[torch.Tensor] = None    # guarded-by: _mu
        self.buckets: Optional[torch.Tensor] = None      # guarded-by: _mu
        self.bucket_live: Optional[torch.Tensor] = None  # guarded-by: _mu
        self.indexed = np.zeros((cap,), dtype=bool)      # guarded-by: _mu
        # slots below it hold no fresh row: a build indexes every live slot
        # below ``n_slots``, and a slot never turns live again once removed
        self._fresh_lo = 0                               # guarded-by: _mu
        # quantized state (device tensors), made at build_index
        self.sq_codes: Optional[torch.Tensor] = None     # guarded-by: _mu
        self.sq_scale: Optional[torch.Tensor] = None     # guarded-by: _mu
        self.pq_codes: Optional[torch.Tensor] = None     # guarded-by: _mu
        self.pq_codebook: Optional[torch.Tensor] = None  # guarded-by: _mu
        # bucket-contiguous mirror for the ivf_topk / pq_topk kernels: row
        # b*cap_b+j holds bucket b's j-th member (slot map + gathered
        # vectors, or PQ codes); rebuilt wholesale with the buckets, rows
        # immutable in between
        self.packed: Optional[Dict[str, torch.Tensor]] = None  # guarded-by: _mu
        # profiling counters (read by the monitor)
        self.counters: Dict[str, float] = {   # guarded-by: _mu
            "inserts": 0, "removals": 0, "searches": 0, "rebuilds": 0,
            "fused_searches": 0,
            "insert_time_s": 0.0, "build_time_s": 0.0, "search_time_s": 0.0,
            "flat_fill": 0.0,
        }
        # optional obs.Tracer: the phase spans of each search, insert and
        # removal on the "db" lane (without one, obs.active_tracer gives the
        # process tracer while a torch profiler runs); a traced call's
        # spans share its number in ``_calls`` as their ``req``
        self.tracer = None
        self._calls = itertools.count(1)

    # -- writes ------------------------------------------------------------

    def insert(self, vectors, chunks: Sequence[Chunk]) -> None:
        """Insert rows (numpy array or tensor ``[n, dim]``) with payloads."""
        t0 = time.perf_counter()
        tr = active_tracer(self.tracer)
        ph = None if tr is None else Phases(tr, next(self._calls))
        n = len(chunks)
        rows = torch.as_tensor(vectors, dtype=torch.float32)
        if tuple(rows.shape) != (n, self.cfg.dim):
            raise ValueError(f"vectors must be [{n}, {self.cfg.dim}], got "
                             f"{tuple(rows.shape)}")
        with self._mu:
            if self.n_slots + n > self.cfg.capacity:
                raise MemoryError(
                    f"vector store full ({self.n_slots}+{n} > "
                    f"{self.cfg.capacity})")
            lo = self.n_slots
            self.n_slots += n
            # fill payloads before flipping live: a concurrent search that
            # snapshotted earlier masks these rows out; one that snapshots
            # after sees complete rows
            self.vectors[lo:lo + n, :self.cfg.dim] = rows.to(self.device)
            for s, c in zip(range(lo, lo + n), chunks):
                c.chunk_id = s
                self.chunks[s] = c
                self.doc_slots.setdefault(c.doc_id, []).append(s)
            self.live[lo:lo + n] = True
            self.counters["inserts"] += n
            self.counters["insert_time_s"] += time.perf_counter() - t0
            if self._main_built() and self.cfg.use_hybrid:
                self._maybe_rebuild(ph)
        if ph is not None:
            ph.close("db.insert", "n", n)

    def remove(self, doc_id: int) -> int:
        tr = active_tracer(self.tracer)
        ph = None if tr is None else Phases(tr, next(self._calls))
        with self._mu:
            slots = self.doc_slots.pop(doc_id, [])
            for s in slots:
                self.live[s] = False
                self.chunks.pop(s, None)
            self.counters["removals"] += len(slots)
        if ph is not None:
            ph.close("db.remove", "n", len(slots))
        return len(slots)

    def update(self, doc_id: int, vectors, chunks: Sequence[Chunk]) -> None:
        """Replace a document's chunks (delete + insert semantics)."""
        with self._mu:
            self.remove(doc_id)
            self.insert(vectors, chunks)

    def set_nprobe(self, nprobe: int) -> None:
        """Adjust IVF probe depth at runtime (the autoscaler quality knob);
        takes effect on the next search."""
        self.cfg.nprobe = max(1, int(nprobe))

    def load_state(self, state: Dict[str, object]) -> None:
        """Replace the whole index state (``repro_torch.convert``).

        ``state`` holds numpy arrays ``vectors [cap,d]``, ``live``,
        ``indexed``, ``centroids``, ``buckets``, ``bucket_live`` (the last
        three None when no IVF index is built), ``sq_codes [cap,d]`` int8,
        ``sq_scale [d]``, ``pq_codes [cap,m]`` int32 and ``pq_codebook
        [m,256,dsub]`` (each None, or absent, when not trained), the int
        ``n_slots`` and the dicts ``chunks`` (slot -> Chunk) and
        ``doc_slots``. The packed mirror is rebuilt from them on the
        ``fused`` rung.
        """
        cap, d = self.cfg.capacity, self.cfg.dim
        if np.shape(state["vectors"]) != (cap, d):
            raise ValueError(f"state vectors must be [{cap}, {d}], got "
                             f"{np.shape(state['vectors'])}")

        def dev(a, dtype):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dtype).to(self.device)

        def wide(a, dtype):   # rows padded to the device width
            return None if a is None else pad_cols(dev(a, dtype), self.width)

        with self._mu:
            self.vectors = wide(state["vectors"], torch.float32)
            self.live = np.asarray(state["live"], dtype=bool).copy()
            self.indexed = np.asarray(state["indexed"], dtype=bool).copy()
            self._fresh_lo = 0
            self.n_slots = int(state["n_slots"])
            self.chunks = dict(state["chunks"])
            self.doc_slots = {k: list(v) for k, v in
                              state["doc_slots"].items()}
            self.centroids = wide(state["centroids"], torch.float32)
            self.buckets = dev(state["buckets"], torch.int32)
            self.bucket_live = dev(state["bucket_live"], torch.bool)
            self.sq_codes = wide(state.get("sq_codes"), torch.int8)
            self.sq_scale = wide(state.get("sq_scale"), torch.float32)
            self.pq_codes = dev(state.get("pq_codes"), torch.int32)
            self.pq_codebook = dev(state.get("pq_codebook"), torch.float32)
            self.packed = None
            if self._kernel == "fused" and self.buckets is not None:
                self._build_packed_locked()

    # -- index build -------------------------------------------------------

    def _main_built(self) -> bool:  # locked-by: _mu
        return self.cfg.index_type == "flat" or self.centroids is not None

    def build_index(self) -> None:
        with self._mu:
            self._build_index_locked()

    def _build_index_locked(self) -> None:  # locked-by: _mu
        t0 = time.perf_counter()
        cfg = self.cfg
        live_idx = np.nonzero(self.live)[0]
        if cfg.quant == "sq8":
            self._train_sq(live_idx)
        if cfg.quant == "pq":
            self._train_pq(live_idx)
        if cfg.index_type == "ivf" and len(live_idx):
            sample = live_idx
            if len(live_idx) > cfg.train_sample:
                rng = np.random.default_rng(0)
                sample = rng.choice(live_idx, cfg.train_sample, replace=False)
            sample_t = torch.as_tensor(sample).to(self.device)
            self.centroids = kmeans(self.vectors[sample_t], cfg.nlist,
                                    cfg.kmeans_iters)
            live_t = torch.as_tensor(live_idx).to(self.device)
            asg = assign(self.vectors, self.centroids, rows=live_t)
            cap_b = cfg.bucket_cap or max(
                16, int(4 * cfg.capacity / cfg.nlist))
            buckets, overflow = fill_buckets(live_t, asg, cfg.nlist, cap_b)
            self.buckets = buckets
            self.bucket_live = buckets >= 0
            if overflow:
                raise MemoryError(f"{overflow} vectors overflowed IVF buckets")
            if self._kernel == "fused":
                self._build_packed_locked()
        self.indexed[:] = False
        self.indexed[live_idx] = True
        self._fresh_lo = self.n_slots
        self.counters["rebuilds"] += 1
        self.counters["build_time_s"] += time.perf_counter() - t0

    def _build_packed_locked(self) -> None:  # locked-by: _mu
        """Rebuild the bucket-contiguous mirror for the fused IVF kernels.

        ``slot`` maps packed row -> original slot id (-1 pad); the gathered
        vector rows (``ivf_topk``) or PQ code rows (``pq_topk``) are copies,
        so later tombstones only affect the search-time ``ok`` mask, never
        the mirrored data. The PQ mirror holds one uint8 per code (the
        reference's is int32; ``pq_codes`` stays int32 as there): it is
        gathered from a uint8 copy of ``pq_codes``, so no int32 mirror is
        allocated.
        """
        slot = self.buckets.reshape(-1).contiguous()
        safe = slot.clamp(min=0).long()
        if self.cfg.quant == "pq" and self.pq_codes is not None:
            self.packed = {"slot": slot,
                           "codes": self.pq_codes.to(torch.uint8)[safe]}
        else:
            self.packed = {"slot": slot, "vecs": self.vectors[safe]}

    def _train_sq(self, live_idx: np.ndarray) -> None:  # locked-by: _mu
        """Per-dimension scale ``max|x| / 127 + 1e-12`` over the live rows
        and int8 codes ``clamp(round(x / scale), -127, 127)`` of every slot
        used so far, ``ASSIGN_CHUNK`` rows at a time (the reference's
        ``_train_sq``, in fp32 on the device); the codes and the scale are
        0 past ``dim``."""
        cfg = self.cfg
        x = self.vectors[: self.n_slots, :cfg.dim]
        live_t = torch.as_tensor(live_idx).to(self.device)
        if len(live_idx):
            amax = torch.zeros(cfg.dim, dtype=torch.float32,
                               device=self.device)
            for lo in range(0, len(live_idx), ASSIGN_CHUNK):
                rows = x[live_t[lo:lo + ASSIGN_CHUNK]]
                amax = torch.maximum(amax, rows.abs().amax(0))
            scale = amax / 127.0 + 1e-12
        else:
            scale = torch.ones(cfg.dim, dtype=torch.float32,
                               device=self.device)
        codes = torch.zeros((cfg.capacity, self.width), dtype=torch.int8,
                            device=self.device)
        for lo in range(0, self.n_slots, ASSIGN_CHUNK):
            hi = min(lo + ASSIGN_CHUNK, self.n_slots)
            codes[lo:hi, :cfg.dim] = torch.round(x[lo:hi] / scale).clamp(
                -127, 127).to(torch.int8)
        self.sq_scale = pad_cols(scale, self.width)
        self.sq_codes = codes

    def _train_pq(self, live_idx: np.ndarray) -> None:  # locked-by: _mu
        """One 256-centroid ``kmeans`` per subspace (seed = subspace) over
        the live rows; a live row's code is its nearest centroid, others
        keep code 0 (the reference's ``_train_pq``)."""
        cfg = self.cfg
        m, dsub = cfg.pq_m, cfg.dim // cfg.pq_m
        live_t = torch.as_tensor(live_idx).to(self.device)
        x = self.vectors[live_t] if len(live_idx) else self.vectors[:1]
        cb = torch.zeros((m, 256, dsub), dtype=torch.float32,
                         device=self.device)
        codes = torch.zeros((cfg.capacity, m), dtype=torch.int32,
                            device=self.device)
        for j in range(m):
            sub = x[:, j * dsub:(j + 1) * dsub].contiguous()
            cb[j] = kmeans(sub, 256, cfg.kmeans_iters, seed=j)
            if len(live_idx):
                codes[live_t, j] = assign(sub, cb[j]).int()
        self.pq_codebook = cb
        self.pq_codes = codes

    def _maybe_rebuild(self, ph: Optional[Phases] = None):  # locked-by: _mu
        # only called with self._mu held (insert path)
        fresh = int((self.live & ~self.indexed).sum())
        self.counters["flat_fill"] = fresh / max(self.cfg.flat_capacity, 1)
        if fresh >= self.cfg.rebuild_threshold * self.cfg.flat_capacity:
            if ph is not None:
                ph.mark()
            self._build_index_locked()
            if ph is not None:
                ph.lap("db.rebuild", "fresh", fresh)

    # -- search ------------------------------------------------------------

    def search(self, vectors, k: int) -> List[SearchResult]:
        t0 = time.perf_counter()
        tr = active_tracer(self.tracer)
        ph = None if tr is None else Phases(tr, next(self._calls))
        q = torch.as_tensor(vectors, dtype=torch.float32).to(
            self.device).contiguous()
        if ph is not None:
            ph.lap("db.upload_q")
        scores, idx = self._search_arrays(q, k, None, self._kernel, ph)
        # the host waits here for the device's lists
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        if ph is not None:
            ph.lap("db.copy_out")
        with self._mu:   # concurrent retrieval replicas share the counters
            self.counters["searches"] += len(vectors)
            if self._kernel == "fused":
                self.counters["fused_searches"] += len(vectors)
            self.counters["search_time_s"] += time.perf_counter() - t0
        out = [SearchResult(chunk_ids=idx[i], scores=scores[i])
               for i in range(len(vectors))]
        if ph is not None:
            ph.lap("db.results")
            ph.close("db.search", "n", len(vectors), "k", k)
        return out

    def _snapshot(self, ph: Optional[Phases] = None) -> Dict[str, object]:
        """Grab a consistent view of all search-relevant index state.

        Mask arrays are copied (writers flip their bits in place); index
        tensors are captured by reference (writers swap whole objects).
        ``vectors`` is referenced, not copied: rows written after the
        snapshot belong to slots that are non-live in the copied masks.
        """
        with self._mu:
            wait_ms = None if ph is None else ph.elapsed_ms()
            snap = {
                "built": self._main_built(),
                "live": self.live.copy(),
                "indexed": self.indexed.copy(),
                "vectors": self.vectors,
                "centroids": self.centroids,
                "buckets": self.buckets,
                "bucket_live": self.bucket_live,
                "sq_codes": self.sq_codes, "sq_scale": self.sq_scale,
                "pq_codes": self.pq_codes, "pq_codebook": self.pq_codebook,
                "packed": self.packed,
                "nprobe": self.cfg.nprobe,
                "fresh_lo": self._fresh_lo,
            }
        if ph is not None:
            ph.lap("db.snapshot", "wait_ms", wait_ms)
        return snap

    def _mask(self, m: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(m).to(self.device)

    def search_arrays(self, q: torch.Tensor, k: int,
                      snap: Optional[Dict[str, object]] = None,
                      rung: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(scores, ids)`` tensors of ``q`` (on the DB's device)
        against ``snap`` (default: a fresh ``_snapshot()``).

        ``rung`` overrides the configured ladder rung for this call, so the
        kernel rungs can be held against ``off`` on one state.
        """
        tr = active_tracer(self.tracer)
        ph = None if tr is None else Phases(tr, next(self._calls))
        rung = self._kernel if rung is None else kernel_ladder(rung)
        return self._search_arrays(q, k, snap, rung, ph)

    def _search_arrays(self, q: torch.Tensor, k: int,
                       snap: Optional[Dict[str, object]], rung: str,
                       ph: Optional[Phases]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``search_arrays`` with the phases ``db.snapshot``, ``db.masks``,
        ``db.main``, ``db.fresh`` and ``db.merge`` recorded on ``ph``."""
        cfg = self.cfg
        if snap is None:
            snap = self._snapshot(ph)
        live, indexed = snap["live"], snap["indexed"]
        qw = pad_cols(q, self.width)   # the queries at the device width
        if not snap["built"]:
            # index never built: brute-force everything (cold start)
            mask = self._mask(live)
            if ph is not None:
                ph.lap("db.masks", "which", "main", "bytes", live.nbytes)
            out = _flat_search(qw, snap["vectors"], mask, k, rung)
            if ph is not None:
                ph.lap("db.main", "op",
                       "plain" if rung == "off" else "topk_search")
            return out
        main_live = live & indexed if cfg.use_hybrid else live
        s_main, i_main = self._search_main(q, main_live, k, snap, rung, ph)
        if not cfg.use_hybrid:
            return s_main, i_main
        fresh = live & ~indexed
        if not fresh.any():
            if ph is not None:
                ph.lap("db.masks", "which", "fresh", "bytes", 0)
                ph.extra = ("fresh", 0)
            return s_main, i_main
        fresh_t = self._mask(fresh)
        if ph is not None:
            ph.lap("db.masks", "which", "fresh", "bytes", fresh.nbytes)
            # counted outside every phase: it is the tracing's own work
            ph.extra = ("fresh", int(np.count_nonzero(
                fresh[snap["fresh_lo"]:])))
            ph.mark()
        # linear scan of the temp flat buffer (the paper's freshness path)
        s_fl, i_fl = _flat_search(qw, snap["vectors"], fresh_t, k, rung)
        if ph is not None:
            ph.lap("db.fresh")
        out = merge_topk(s_main, i_main, s_fl, i_fl, k)
        if ph is not None:
            ph.lap("db.merge")
        return out

    def _search_main(self, q, main_live: np.ndarray, k: int,
                     snap: Dict[str, object], rung: str,
                     ph: Optional[Phases] = None):
        """The main index's top-k of ``q`` (at ``dim`` or ``width``): the
        PQ paths take it at ``dim`` (their tables split the true row into
        subspaces), every other path at ``width``, against the padded
        device rows. ``ph`` records ``db.masks`` (the mask's arithmetic
        and upload) and ``db.main`` (the entry point's call, named by
        ``op``)."""
        cfg = self.cfg
        q, qw = q[:, :cfg.dim], pad_cols(q, self.width)
        live = self._mask(main_live)
        if ph is not None:
            ph.lap("db.masks", "which", "main", "bytes", main_live.nbytes)
        if cfg.index_type == "flat":
            if cfg.quant == "sq8" and snap["sq_codes"] is not None:
                op = ("sq8_topk" if rung == "fused" else "quant_score"
                      if rung == "op" else "plain")
                out = _sq8_flat_search(qw, snap["sq_codes"],
                                       snap["sq_scale"], live, k, rung)
            else:
                op = "plain" if rung == "off" else "topk_search"
                out = _flat_search(qw, snap["vectors"], live, k, rung)
        else:
            nprobe = min(int(snap["nprobe"]), cfg.nlist)
            packed = snap["packed"]
            pq = cfg.quant == "pq"
            cent = snap["centroids"]
            if pq:
                cent = cent[:, :cfg.dim].contiguous()
            if rung == "fused" and packed is not None:
                # ok recomputed per search on the device from the
                # snapshot's mask: a tombstone lands as ok=0 on its packed
                # row
                slot = packed["slot"]
                ok = (slot >= 0) & live[slot.clamp(min=0)]
                if pq and "codes" in packed:
                    op = "pq_topk"
                    out = kops.pq_topk(q, snap["pq_codebook"], cent,
                                       packed["codes"], slot, ok, nprobe, k)
                else:
                    op = "ivf_topk"
                    out = kops.ivf_topk(qw, cent, packed["vecs"], slot, ok,
                                        nprobe, k)
            elif pq and snap["pq_codes"] is not None:
                op = "plain"
                out = _pq_ivf_search(q, snap["pq_codes"],
                                     snap["pq_codebook"], live, cent,
                                     snap["buckets"], snap["bucket_live"],
                                     nprobe, k)
            else:
                op = "plain"
                out = _ivf_search(qw, snap["vectors"], live, cent,
                                  snap["buckets"], snap["bucket_live"],
                                  nprobe, k)
        if ph is not None:
            ph.lap("db.main", "op", op)
        return out

    # -- misc --------------------------------------------------------------

    def get_chunk(self, chunk_id: int) -> Optional[Chunk]:
        with self._mu:
            return self.chunks.get(int(chunk_id))

    def get_chunks(self, chunk_ids: Sequence[int]) -> List[Optional[Chunk]]:
        """Batched payload lookup: one call for a whole candidate set."""
        with self._mu:
            return [self.chunks.get(int(c)) for c in chunk_ids]

    def stats(self) -> Dict[str, float]:
        with self._mu:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, float]:  # locked-by: _mu
        cfg = self.cfg
        index_bytes = 0
        if self.centroids is not None:
            index_bytes += (self.centroids.nbytes + self.buckets.nbytes)
        # the reference's formulas (bytes as it counts them, not the
        # tensors' sizes)
        if self.sq_codes is not None:
            index_bytes += self.n_slots * cfg.dim
        if self.pq_codes is not None:
            index_bytes += self.n_slots * cfg.pq_m + self.pq_codebook.nbytes
        return {
            "live": float(self.live.sum()),
            "slots": float(self.n_slots),
            "vector_bytes": float(self.n_slots * cfg.dim * 4),
            "index_bytes": float(index_bytes),
            "fresh": float((self.live & ~self.indexed).sum()),
            **self.counters,
        }


@register("vectordb", "torch")
def make_db(index_type: str = "ivf", quant: str = "none", dim: int = 384,
            device=None, **kw) -> TorchVectorDB:
    return TorchVectorDB(DBConfig(index_type=index_type, quant=quant, dim=dim,
                                  **kw), device=device)


@register("vectordb", "torch_fused")
def make_fused_db(index_type: str = "ivf", quant: str = "none",
                  dim: int = 384, device=None, **kw) -> TorchVectorDB:
    """``vectordb:torch`` pinned to the ``fused`` rung: one retrieve
    micro-batch is one main-index launch (``ivf_topk``, ``pq_topk`` for IVF
    + pq, ``sq8_topk`` for flat + sq8, ``topk_search`` for flat) plus one
    ``topk_search`` launch while the freshness buffer holds rows."""
    kw.setdefault("use_kernel", "fused")
    if kernel_ladder(kw["use_kernel"]) != "fused":
        raise ValueError(
            f"vectordb:torch_fused requires use_kernel='fused', got "
            f"{kw['use_kernel']!r}")
    return TorchVectorDB(DBConfig(index_type=index_type, quant=quant, dim=dim,
                                  **kw), device=device)
