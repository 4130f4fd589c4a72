"""The traced run: host spans around the program's layer calls, a
``torch.profiler`` trace of the device over a short sub-window, and the
reduction of both to what the per-layer metrics read.

Spans are the benchmark's own (``record.Spans``): the DB's searches and
the kernel entry points of ``repro_torch.kernels.ops``, each with its host
interval and OS thread, and what the entry points' costs need of their
arguments. The profiler traces the device: its kernels, copies and fills,
and the runtime calls that launched them. A kernel belongs to the span
that was open when it was launched (the runtime call's correlation id
ties the two). The profiler gives every launching thread of a process one
id, so where several client threads launch at once a launch cannot be
told apart by its thread: a kernel's roofline share counts the entry
point's own kernels by name (``KERNELS``).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

OPS = ("ivf_topk", "sq8_topk", "topk_search")


class Tracer:
    def __init__(self, dep):
        self.dep = dep
        self.spans = dep.log.spans
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self._undo: List[Callable[[], None]] = []

    # -- spans around the program's calls ------------------------------------

    def _wrap(self, obj, attr: str, name: str, meta_fn=None):
        orig = getattr(obj, attr)
        spans = self.spans

        def wrapped(*a, **kw):
            meta = meta_fn(*a, **kw) if meta_fn and spans.on else {}
            with spans.span(name, **meta):
                return orig(*a, **kw)

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: setattr(obj, attr, orig))

    def install(self) -> None:
        """Wrap the program's calls in spans, and start and stop the
        profiler once, so that its first start (CUPTI's set-up) is paid in
        set-up and not in the sub-window."""
        from repro_torch.kernels import ops

        self.start()
        self.stop()
        self.prof, self.t0_ns, self.t1_ns = None, 0, 0
        self.spans.items.clear()

        for op in OPS:
            self._wrap(ops, op, "op." + op, META[op])

    def uninstall(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    # -- the profiled sub-window --------------------------------------------

    def start(self) -> None:
        if self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        # the device and its runtime calls only: recording every CPU
        # operation of the launching thread would slow it down
        acts = ([ProfilerActivity.CUDA] if self.dep.device.type == "cuda"
                else [ProfilerActivity.CPU])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0_ns = time.time_ns()
        self.spans.on = True

    def stop(self) -> None:
        if self.prof is None or self.t1_ns:
            return
        if self.dep.device.type == "cuda":
            torch.cuda.synchronize(self.dep.device)
        self.t1_ns = time.time_ns()
        self.spans.on = False
        self.prof.stop()

    @property
    def done(self) -> bool:
        return bool(self.t1_ns)

    def reduce(self) -> "TraceData":
        return TraceData(self)


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


class TraceData:
    """The sub-window's device activity, its launches and the host spans."""

    def __init__(self, tr: Tracer):
        self.t0, self.t1 = tr.t0_ns, tr.t1_ns
        self.window_s = (self.t1 - self.t0) / 1e9
        dev: List[Tuple[str, int, int, int]] = []
        launch: Dict[int, Tuple[int, int]] = {}
        events = tr.prof.profiler.kineto_results.events() if tr.prof else []
        for e in events:
            if _is_device(e):
                dev.append((e.name(), e.start_ns(), e.duration_ns(),
                            e.correlation_id()))
            elif e.correlation_id() and e.name().startswith("cu"):
                # a runtime or driver call (a launch, copy or fill)
                launch[e.correlation_id()] = (e.start_ns(),)
        self.device_ops = dev
        self.n_launch_events = len(launch)
        # each device operation's launch time, where the trace has it
        launches = sorted((launch[corr][0], dur / 1e9, name)
                          for name, _, dur, corr in dev if corr in launch)
        self.launches = launches
        self.matched = len(launches)
        self.spans = [s for s in tr.spans.items
                      if s[2] >= self.t0 and s[3] <= self.t1]
        self.busy_s = self._busy()

    def _busy(self) -> float:
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d, _ in self.device_ops)
        total, end = 0, self.t0
        for a, b in iv:
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total / 1e9

    def launched(self, span) -> List[Tuple[float, str]]:
        """(device seconds, name) of the operations launched while ``span``
        was open, from any thread: exact where one thread launches."""
        _, _, a, b, _ = span
        ks = self.launches
        lo = bisect.bisect_left(ks, (a, -1.0, ""))
        hi = bisect.bisect_right(ks, (b, float("inf"), "\uffff"))
        return [(d, n) for _, d, n in ks[lo:hi]]

    def spans_named(self, name: str) -> List[tuple]:
        return [s for s in self.spans if s[0] == name]

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        """The ten device operations that took most time, and the ten
        longest idle gaps named by the innermost host span open at their
        middle."""
        tot: Dict[str, float] = defaultdict(float)
        for name, _, d, _ in self.device_ops:
            tot[name[:120]] += d / 1e9
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        iv = sorted((s, s + d) for _, s, d, _ in self.device_ops)
        gaps, end = [], self.t0
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            open_ = [s for s in self.spans if s[2] <= mid <= s[3]]
            name = (min(open_, key=lambda s: s[3] - s[2])[0] if open_
                    else "host.other")
            named.append([name, (b - a) / 1e9])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def _flat_meta(q, vecs, live, k):
    return {"nq": q.shape[0], "d": q.shape[1], "k": k, "live": live}


def _sq8_meta(q, codes, scale, live, k):
    return {"nq": q.shape[0], "d": q.shape[1], "k": k, "live": live}


def _ivf_meta(q, cent, vecs, slot, ok, nprobe, k):
    return {"q": q, "cent": cent, "ok": ok, "nprobe": nprobe, "k": k}


# what a call's cost needs, kept from its arguments (never the big tensors
# themselves: a live mask or an ok mask at most)
META = {"topk_search": _flat_meta, "sq8_topk": _sq8_meta,
        "ivf_topk": _ivf_meta}


def op_cost(name: str, meta: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """The frozen yardstick's work of one entry-point call
    (``ragbench.roofline``)."""
    from ragbench import roofline as R

    if name == "op.topk_search":
        return R.topk_search_cost(meta["nq"], meta["d"], meta["k"],
                                  int(meta["live"].sum()))
    if name == "op.sq8_topk":
        return R.sq8_topk_cost(meta["nq"], meta["d"], meta["k"],
                               int(meta["live"].sum()))
    if name == "op.ivf_topk":
        q, cent = meta["q"], meta["cent"]
        nlist = cent.shape[0]
        fill = meta["ok"].reshape(nlist, -1).sum(1)
        probes = (q.float() @ cent.float().T).topk(meta["nprobe"],
                                                   dim=1).indices
        distinct = torch.unique(probes)
        return R.ivf_topk_cost(q.shape[0], q.shape[1], meta["k"], nlist,
                               int(fill[distinct].sum()),
                               int(fill[probes].sum()))
    return None


# each entry point's own CUDA kernels (``csrc/``), by name
KERNELS = {"op.ivf_topk": ("probe_kernel(", "invert_kernel(",
                           "ivf_bucket_kernel(", "merge::merge_kernel("),
           "op.sq8_topk": ("sq8_wgmma_kernel<", "merge::merge_kernel("),
           "op.topk_search": ("topk_tile_kernel(",)}


def kernel_seconds(td: TraceData, name: str) -> float:
    """Device seconds of the entry point's own kernels in the sub-window."""
    keys = KERNELS[name]
    return sum(d for n, _, d, _ in td.device_ops
               if any(k in n for k in keys)) / 1e9


def roofline_share(td: TraceData, name: str) -> Optional[float]:
    """Percent of the least time the sub-window's calls of ``name`` could
    take (the frozen yardstick's work, from each call's arguments), over
    the device time of that entry point's own kernels in the sub-window.
    The kernels are found by name, so calls from several threads at once
    count alike."""
    from ragbench import roofline as R

    bound_s = 0.0
    for s in td.spans_named(name):
        cost = op_cost(name, s[4])
        if cost is not None:
            bound_s += R.bound(cost["bytes"], cost["flops"], cost["peak"])[0]
    dev_s = kernel_seconds(td, name)
    if dev_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / dev_s
