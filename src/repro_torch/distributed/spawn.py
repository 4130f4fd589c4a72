"""Run one function on several ranks of a fresh process group: the port's
small launcher for multi-process tests and for several ranks on one card.

``run_ranks(fn, n, *args, store_dir=...)`` spawns ``n`` processes (the
``spawn`` start method: nothing is inherited but the arguments), starts a
process group of ``n`` ranks on ``backend`` over a ``FileStore`` under
``store_dir`` (no TCP port, so concurrent runs never collide), calls
``fn(rank, *args)`` on each, and returns the ranks' results in rank order.
A rank that raises, dies or outlives ``timeout`` fails the whole run:
every process is joined or killed before ``run_ranks`` returns or raises.
``fn`` and its arguments are pickled: ``fn`` must be importable by name.
"""
from __future__ import annotations

import os
import traceback
from typing import Callable, List, Optional

import torch


def gloo_cuda_all_gather() -> None:
    """Route the functional all-gather on CUDA tensors (DTensor's) through
    ``dist.all_gather_into_tensor``, this process only. gloo's coalesced
    all-gather, which the functional op calls, reads CUDA memory from the
    host and crashes the process (torch 2.11, 4 ranks on one card: PERF.md
    §6, PR 23); gloo's plain all-gather stages CUDA tensors through the
    host as its other CUDA collectives do. The result and its placement
    are the same; it waits for the collective before it returns."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((group_size * inp.shape[0], *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    _LIBS.append(torch.library.Library("_c10d_functional", "IMPL"))
    _LIBS[-1].impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")


_LIBS: list = []   # keeps the registrations alive
PG_TIMEOUT_S = 120   # a collective's wait for a rank that failed


def _rank_main(rank: int, n: int, backend: str, store_path: str,
               out_dir: str, fn: Callable, args: tuple,
               cuda_device: Optional[int]) -> None:
    import datetime

    import torch.distributed as dist

    import faulthandler

    faulthandler.enable()   # a crash in native code prints the stack
    out = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        if cuda_device is not None:
            torch.cuda.set_device(cuda_device)
            if backend == "gloo":
                gloo_cuda_all_gather()
        dist.init_process_group(
            backend, init_method=f"file://{store_path}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": True, "result": result}, out)
    except BaseException:   # reported to the parent, then exit non-zero
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise SystemExit(1)


def run_ranks(fn: Callable, n: int, *args, store_dir: str,
              backend: str = "gloo", timeout: float = 300.0,
              cuda_device: Optional[int] = None) -> List[object]:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each on its own rank of
    an ``n``-rank group. ``cuda_device`` pins every rank to one card (the
    ranks then share it, so the backend must be gloo). A collective that
    waits PG_TIMEOUT_S for a rank that failed raises on the others."""
    import multiprocessing as mp
    import time

    store_dir = os.path.abspath(store_dir)   # a file:// URL needs it whole
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    for r in range(n):
        stale = os.path.join(store_dir, f"rank{r}.pt")
        if os.path.exists(stale):
            os.remove(stale)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, backend, store, store_dir, fn, args,
                               cuda_device), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
    results, errors = [], []
    for r, p in enumerate(procs):
        path = os.path.join(store_dir, f"rank{r}.pt")
        if p in late:
            errors.append(f"rank {r}: still running after {timeout} s")
        elif not os.path.exists(path):
            errors.append(f"rank {r}: exited {p.exitcode} with no result")
        else:
            rec = torch.load(path, weights_only=False)
            if rec["ok"]:
                results.append(rec["result"])
            else:
                errors.append(f"rank {r}:\n{rec['error']}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
