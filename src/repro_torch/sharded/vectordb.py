"""Row-partitioned vector DB over N shards: the port of
``repro.sharded.vectordb``.

``ShardedVectorDB`` implements the same ``DBInstance`` abstraction as
``TorchVectorDB`` and registers as the ``torch_sharded`` vectordb backend
(the twin of the reference's ``sharded``), so any ``PipelineSpec`` selects
it and its shard count declaratively::

    "vectordb": {"component": "torch_sharded",
                 "options": {"n_shards": 4, "index_type": "ivf"}}

Design (the reference's):

- **Partitioning**: the corpus is row-partitioned into ``n_shards``
  independent ``TorchVectorDB`` instances on one device (flat and IVF, with
  sq8 or pq). Documents route to shards by a deterministic hash of
  ``doc_id`` (``doc_shard``), so every chunk of a document lands on one
  shard and removals and updates find it again without a global id map.
- **Global ids**: ``global_id = shard * shard_capacity + local_slot``. At
  ``n_shards=1`` global ids are the local slots and every shard setting
  passes through unchanged, so a 1-shard DB gives a bare ``TorchVectorDB``'s
  output.
- **Search**: every shard's snapshot is taken under one wrapper lock (a
  consistent cross-shard view), then each shard computes its local top-k
  and the lists fold pairwise through ``merge_topk``: only O(shards·k)
  winners cross shard boundaries. The per-shard lists, the id offsets and
  the merges stay on the DB's device; one copy to the host ends a search.
  Global ids never repeat across shards, so the port's ``merge_topk`` (a
  stable sort without dedup) gives the reference's order, which takes its
  vectorized, no-dedup path in that case.
- **Mutations**: the elastic executor's serialized writer calls
  ``insert``/``remove``/``update`` here; the wrapper groups a batch by
  target shard and applies the groups shard-parallel (each shard has its
  own lock). Rebuild thresholds are per shard.
- **Knobs**: ``set_nprobe`` updates every shard under the lock searches
  snapshot under, so one search never mixes nprobe levels.

- **Mesh search** (``_mesh_search``): when a ``DeviceMesh`` is active
  (``distributed.sharding.sharding_rules``) whose ``corpus_axes`` dims
  hold ``n_shards`` ranks, a plain flat DB (quant ``none``) searches
  SPMD: every rank holds the same host-side bookkeeping and applies the
  same mutations; rank r's device holds only shard r's rows and live mask
  of the current epoch (rebuilt when a mutation moves the epoch), scans
  them with the ``topk_search`` kernel (``collectives.make_sharded_topk``),
  and the ranks all-gather their k winners and merge them. Every rank of
  the corpus dims must call ``search`` together. The flat scan covers
  exactly the live rows, so the freshness buffer folds in. Other indexes
  and no mesh take the host-side merge; ``mesh_searches`` counts the mesh
  path.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Mapping, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.interfaces import Chunk, DBInstance, SearchResult
from repro_torch.core.registry import register
from repro_torch.core.vectordb import DBConfig, TorchVectorDB, merge_topk
from repro_torch.distributed.collectives import (corpus_group,
                                                 make_sharded_topk)
from repro_torch.distributed.sharding import active_mesh, mesh_shape
from repro_torch.kernels.ref import NEG, pad_cols
from repro_torch.obs.tracer import active_tracer


def doc_shard(doc_id: int, n_shards: int) -> int:
    """Deterministic doc→shard assignment (murmur-style integer mix, so
    sequential doc ids spread instead of striping)."""
    if n_shards <= 1:
        return 0
    x = (int(doc_id) ^ 0x9E3779B9) & 0xFFFFFFFF
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x % n_shards


@dataclass
class ShardedDBConfig:
    """Global-view config; per-shard ``DBConfig`` values are derived."""

    n_shards: int = 4
    index_type: str = "ivf"          # flat | ivf
    quant: str = "none"              # none | sq8 | pq
    dim: int = 384
    capacity: int = 1 << 16          # global row budget
    nlist: int = 64                  # global IVF lists (split across shards)
    nprobe: int = 8
    use_hybrid: bool = True
    flat_capacity: int = 4096        # global freshness budget (split)
    rebuild_threshold: float = 0.75
    # kernel ladder rung, passed through to every shard's DBConfig:
    # False/"off" | True/"op" | "fused"; each shard's search_arrays runs
    # its own kernels over its own packed mirror
    use_kernel: object = False
    train_sample: int = 16384
    balance_slack: float = 1.5       # per-shard headroom over an even split
    use_mesh: bool = True            # mesh scan when an active mesh matches
    corpus_axes: Tuple[str, ...] = ("pod", "data")


class _DocSlotsView(Mapping):
    """Read-only ``doc_id -> [global chunk ids]`` view over all shards
    (keeps ``gold_chunks_for`` and other ``db.doc_slots`` users working)."""

    def __init__(self, db: "ShardedVectorDB"):
        self._db = db

    def __getitem__(self, doc_id: int) -> List[int]:
        sid = doc_shard(doc_id, self._db.cfg.n_shards)
        slots = self._db.shards[sid].doc_slots[doc_id]
        return [sid * self._db.shard_capacity + int(s) for s in slots]

    def __iter__(self) -> Iterator[int]:
        for sh in self._db.shards:
            yield from sh.doc_slots

    def __len__(self) -> int:
        return sum(len(sh.doc_slots) for sh in self._db.shards)

    def __contains__(self, doc_id) -> bool:
        sid = doc_shard(doc_id, self._db.cfg.n_shards)
        return doc_id in self._db.shards[sid].doc_slots


class ShardedVectorDB(DBInstance):
    """N-way row-partitioned vector DB with an O(shards·k) merge, every
    shard on ``device`` (None: cuda)."""

    def __init__(self, cfg: ShardedDBConfig, device=None):
        if cfg.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {cfg.n_shards}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._mu = threading.RLock()   # cross-shard snapshot/mutation fence
        self.shards: List[TorchVectorDB] = [
            TorchVectorDB(self._shard_cfg(), device=self.device)
            for _ in range(cfg.n_shards)]
        self.shard_capacity = self.shards[0].cfg.capacity
        self.doc_slots = _DocSlotsView(self)
        self.counters: Dict[str, float] = {   # guarded-by: _mu
            "searches": 0, "search_time_s": 0.0, "mesh_searches": 0,
            "merge_time_s": 0.0,
        }
        self._epoch = 0                # guarded-by: _mu
        # mesh-path caches: (fn, shard id) per (mesh, k), and this rank's
        # shard rows and live mask on the mesh's device for one epoch
        self._mesh_fns: Dict[Tuple[int, int], Tuple[Callable, int]] = {}  # guarded-by: _mu
        self._mesh_arrays: Optional[Tuple[int, torch.Tensor, torch.Tensor]] = None  # guarded-by: _mu
        # optional obs.Tracer: fan-out/merge spans on the "db" thread lane
        # (the reference's spans). Without one, obs.active_tracer gives the
        # process tracer while a torch profiler runs, on which the shards'
        # phase spans also land, inside each ``db.shard_scan``
        self.tracer = None

    def _shard_cfg(self) -> DBConfig:
        """Derive one shard's ``DBConfig`` from the global view.

        At ``n_shards=1`` every value passes through unchanged (the parity
        guarantee); otherwise capacities and lists split proportionally,
        with ``balance_slack`` headroom absorbing hash-routing imbalance.
        ``bucket_cap``, ``pq_m`` and ``kmeans_iters`` keep ``DBConfig``'s
        defaults (an automatic bucket capacity), as in the reference.
        """
        c = self.cfg
        n = c.n_shards
        if n == 1:
            cap, nlist, flat = c.capacity, c.nlist, c.flat_capacity
        else:
            cap = min(c.capacity,
                      int(np.ceil(c.capacity / n * c.balance_slack)))
            nlist = max(4, c.nlist // n)
            flat = max(16, int(np.ceil(c.flat_capacity / n)))
        return DBConfig(index_type=c.index_type, quant=c.quant, dim=c.dim,
                        capacity=cap, nlist=nlist, nprobe=c.nprobe,
                        flat_capacity=flat,
                        rebuild_threshold=c.rebuild_threshold,
                        use_hybrid=c.use_hybrid, use_kernel=c.use_kernel,
                        train_sample=c.train_sample)

    # -- id codec ----------------------------------------------------------

    def _to_global(self, sid: int, local: int) -> int:
        return sid * self.shard_capacity + int(local)

    def _locate(self, global_id: int) -> Tuple[int, int]:
        return divmod(int(global_id), self.shard_capacity)

    def _parallel(self, fns: List[Callable[[], None]]) -> None:
        """Apply per-shard closures shard-parallel (shards are independent
        databases; each serializes internally on its own lock)."""
        if len(fns) <= 1:
            for fn in fns:
                fn()
            return
        with ThreadPoolExecutor(max_workers=len(fns)) as ex:
            for f in [ex.submit(fn) for fn in fns]:
                f.result()

    # -- writes ------------------------------------------------------------

    def insert(self, vectors, chunks: Sequence[Chunk]) -> None:
        """Insert rows (numpy array or tensor ``[n, dim]``) with payloads;
        each chunk's ``chunk_id`` becomes its global id."""
        n = len(chunks)
        rows = torch.as_tensor(vectors, dtype=torch.float32)
        if tuple(rows.shape) != (n, self.cfg.dim):
            raise ValueError(f"vectors must be [{n}, {self.cfg.dim}], got "
                             f"{tuple(rows.shape)}")
        with self._mu:
            groups: Dict[int, List[int]] = {}
            for j, c in enumerate(chunks):
                groups.setdefault(
                    doc_shard(c.doc_id, self.cfg.n_shards), []).append(j)

            def apply(sid: int, sel: List[int]) -> None:
                sub = [chunks[j] for j in sel]
                self.shards[sid].insert(
                    rows[torch.as_tensor(sel, device=rows.device)], sub)
                for c in sub:   # shard assigned local slots; re-key globally
                    c.chunk_id = self._to_global(sid, c.chunk_id)

            self._parallel([lambda s=s, r=r: apply(s, r)
                            for s, r in groups.items()])
            self._epoch += 1

    def remove(self, doc_id: int) -> int:
        with self._mu:
            sid = doc_shard(doc_id, self.cfg.n_shards)
            n = self.shards[sid].remove(doc_id)
            if n:
                self._epoch += 1
            return n

    def update(self, doc_id: int, vectors, chunks: Sequence[Chunk]) -> None:
        """Replace a document's chunks (delete + insert semantics)."""
        with self._mu:
            self.remove(doc_id)
            self.insert(vectors, chunks)

    def set_nprobe(self, nprobe: int) -> None:
        """Quality-knob update, atomic across shards: holds the same lock
        search snapshots under, so one search never mixes nprobe levels."""
        with self._mu:
            for sh in self.shards:
                sh.set_nprobe(nprobe)
            self.cfg.nprobe = max(1, int(nprobe))

    def build_index(self) -> None:
        with self._mu:
            self._parallel([sh.build_index for sh in self.shards])
            self._epoch += 1

    def load_state(self, state: Dict[str, object]) -> None:
        """Replace every shard's state and the wrapper's epoch and counters
        (``repro_torch.convert.sharded_db_state``): ``shards`` holds one
        ``TorchVectorDB.load_state`` argument per shard."""
        if len(state["shards"]) != self.cfg.n_shards:
            raise ValueError(f"{len(state['shards'])} shard states for "
                             f"{self.cfg.n_shards} shards")
        with self._mu:
            for sh, st in zip(self.shards, state["shards"]):
                sh.load_state(st)
            self._epoch = int(state.get("epoch", 0))
            self.counters.update(state.get("counters", {}))

    # -- search ------------------------------------------------------------

    def search(self, vectors, k: int) -> List[SearchResult]:
        t0 = time.perf_counter()
        q = torch.as_tensor(vectors, dtype=torch.float32).to(
            self.device).contiguous()
        scores, idx = self.search_arrays(q, k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        dt = time.perf_counter() - t0
        with self._mu:
            self.counters["searches"] += len(vectors)
            self.counters["search_time_s"] += dt
        tr = active_tracer(self.tracer)
        if tr is not None:
            te = tr.now()
            tr.add_span("db.search", te - dt, te, cat="db", tid="db",
                        thread=threading.get_native_id(), n=len(vectors),
                        k=k, shards=self.cfg.n_shards)
        return [SearchResult(chunk_ids=idx[i], scores=scores[i])
                for i in range(len(vectors))]

    def snapshot(self) -> List[Dict[str, object]]:
        """Every shard's snapshot, taken under the wrapper's lock: one
        consistent cross-shard view."""
        with self._mu:
            return [sh._snapshot() for sh in self.shards]

    def search_arrays(self, q: torch.Tensor, k: int,
                      snaps: Optional[List[Dict[str, object]]] = None,
                      rung: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(scores, global ids)`` tensors of ``q`` (on the DB's
        device) against ``snaps`` (default: a fresh ``snapshot()``);
        ``rung`` overrides every shard's ladder rung for this call. With
        neither, an eligible DB under an active mesh takes the mesh path
        (its results on the mesh's device)."""
        if snaps is None:
            with self._mu:   # one consistent cross-shard view and its epoch
                snaps = [sh._snapshot() for sh in self.shards]
                epoch = self._epoch
            if rung is None:
                out = self._mesh_search(q, k, snaps, epoch)
                if out is not None:
                    return out
        return self._merge_search(q, k, snaps, rung)

    def _mesh_search(self, q, k: int, snaps, epoch: int
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The SPMD scan when a matching mesh is active, else ``None``.

        Eligible only for the plain flat scan (exact over all live rows:
        the flat main index and the flat freshness buffer together cover
        exactly ``live``); IVF and quantized indexes take the host-side
        merge, as in the reference."""
        cfg = self.cfg
        mesh = active_mesh() if cfg.use_mesh else None
        if (mesh is None or cfg.index_type != "flat" or cfg.quant != "none"
                or cfg.n_shards == 1):
            return None
        shape = mesh_shape(mesh)
        axes = tuple(a for a in cfg.corpus_axes if a in shape)
        if not axes:
            return None
        if int(np.prod([shape[a] for a in axes])) != cfg.n_shards:
            return None
        dev = torch.device(mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (id(mesh), k)
        with self._mu:
            if key not in self._mesh_fns:
                fn, _ = make_sharded_topk(mesh, k, corpus_axes=axes)
                self._mesh_fns[key] = (fn, corpus_group(mesh, axes)[1])
            fn, sid = self._mesh_fns[key]
            if self._mesh_arrays is None or self._mesh_arrays[0] != epoch:
                snap = snaps[sid]
                self._mesh_arrays = (
                    epoch, snap["vectors"].to(dev),
                    torch.from_numpy(snap["live"]).to(dev))
            _, vecs, live = self._mesh_arrays
        # the scan runs lock-free: rows written after the snapshot land in
        # slots that this epoch's live mask leaves dead
        s, gi = fn(pad_cols(q.to(dev), vecs.shape[1]), vecs, live)
        with self._mu:
            self.counters["mesh_searches"] += 1
        return s, gi

    def _merge_search(self, q, k: int, snaps, rung=None):
        """Per-shard local top-k → global ids → pairwise merge reduction,
        on the device."""
        tr = active_tracer(self.tracer)
        per: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for sid, (sh, snap) in enumerate(zip(self.shards, snaps)):
            kl = min(k, sh.cfg.capacity)
            ts = None if tr is None else tr.now()
            s, i = sh.search_arrays(q, kl, snap, rung=rung)
            if tr is not None:
                tr.add_span("db.shard_scan", ts, tr.now(), cat="db",
                            tid="db", thread=threading.get_native_id(),
                            shard=sid)
            # flat scans keep dead-slot ids at NEG score; mask them out so
            # they never shadow a real winner from another shard
            valid = (s > NEG / 2) & (i >= 0)
            gi = torch.where(valid, i + sid * self.shard_capacity,
                             torch.full_like(i, -1))
            if kl < k:   # tiny shard: pad to k so merge shapes line up
                s = torch.cat([s, s.new_full((s.shape[0], k - kl), NEG)], 1)
                gi = torch.cat([gi, gi.new_full((gi.shape[0], k - kl), -1)],
                               1)
            per.append((s, gi))
        t0 = time.perf_counter()
        s, gi = per[0]
        for s2, gi2 in per[1:]:   # cross-shard id ranges are disjoint
            s, gi = merge_topk(s, gi, s2, gi2, k)
        dtm = time.perf_counter() - t0
        with self._mu:
            self.counters["merge_time_s"] += dtm
        if tr is not None:
            te = tr.now()
            tr.add_span("db.merge", te - dtm, te, cat="db", tid="db",
                        thread=threading.get_native_id(), shards=len(per))
        return s, gi

    # -- payloads / stats --------------------------------------------------

    def get_chunk(self, chunk_id: int) -> Optional[Chunk]:
        cid = int(chunk_id)
        if cid < 0:
            return None
        sid, slot = self._locate(cid)
        if sid >= self.cfg.n_shards:
            return None
        return self.shards[sid].get_chunk(slot)

    def get_chunks(self, chunk_ids: Sequence[int]) -> List[Optional[Chunk]]:
        return [self.get_chunk(c) for c in chunk_ids]

    def shard_stats(self) -> List[Dict[str, float]]:
        """Per-shard stats rows (monitor gauges / dashboards)."""
        return [sh.stats() for sh in self.shards]

    def stats(self) -> Dict[str, float]:
        per = self.shard_stats()
        agg: Dict[str, float] = {}
        for row in per:
            for key, val in row.items():
                agg[key] = agg.get(key, 0.0) + float(val)
        lives = [row["live"] for row in per]
        mean_live = float(np.mean(lives)) if lives else 0.0
        with self._mu:
            agg.update(self.counters)
        agg["n_shards"] = float(self.cfg.n_shards)
        agg["shard_live_min"] = float(min(lives)) if lives else 0.0
        agg["shard_live_max"] = float(max(lives)) if lives else 0.0
        # 1.0 == perfectly balanced; the hash router should stay near it
        agg["shard_imbalance"] = (float(max(lives)) / mean_live
                                  if mean_live > 0 else 1.0)
        return agg

    def gauges(self) -> Dict[str, Callable[[], float]]:
        """Monitor gauges: shard count, balance, mesh-path usage."""
        return {
            "db_shards": lambda: float(self.cfg.n_shards),
            "db_shard_imbalance": lambda: self.stats()["shard_imbalance"],
            "db_mesh_searches": lambda: float(
                self.counters["mesh_searches"]),  # noqa: lock-discipline -- monitor-only sample; single dict read is GIL-atomic
        }


@register("vectordb", "torch_sharded")
def make_sharded_db(n_shards: int = 4, index_type: str = "ivf",
                    quant: str = "none", dim: int = 384, device=None,
                    **kw) -> ShardedVectorDB:
    return ShardedVectorDB(ShardedDBConfig(
        n_shards=n_shards, index_type=index_type, quant=quant, dim=dim,
        **kw), device=device)
