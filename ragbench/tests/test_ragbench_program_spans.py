"""The readers of the program's own spans (``repro_torch.obs``'s process
tracer): a tiny traced cell on the CPU reads the DB's phases and writes; on
hand-placed device intervals and spans the two idle shares split
``idle_share.search`` exactly; a program without the process tracer gives
nothing to read; and on the card the benchmark's CUDA-only profiler turns
the program's spans on."""
import json
import time
from types import SimpleNamespace

import pytest
import torch

from ragbench import run as R
from ragbench.cell import load_cell, manifest
from ragbench.metrics._lib import Ctx
from ragbench.trace import TraceData

CELLS = [w["name"] for w in manifest()["workloads"]]
SEED = 2 ** 31 + 11
SPAN_READERS = ("db_prep_ms", "db_results_ms", "db_write_ms")
IDLE_READERS = ("idle_in_db_share", "idle_outside_db_share")
MS = 1_000_000


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run_reads_the_db_phases(name):
    """At the tiny size, 100 traced searches hold writes too (the mix's
    10 %); on the CPU the profiler sees no device, so the idle split is
    left out, as ``idle_share.search`` is."""
    cell = load_cell(name, tiny=True)
    cell.mix["trace"]["calls"] = 100
    out, _ = R.run(cell, SEED, 4.0, True, device="cpu")
    got = json.loads(R.result_line(out))["metrics"]
    for m in SPAN_READERS:
        assert got[m]["value"] > 0 and got[m]["unit"] == "ms", m
    for m in IDLE_READERS + ("idle_share.search",):
        assert m not in got


def _trace_data(t0, ops):
    """A ``TraceData`` over ``[t0, t0 + 100 ms]`` with device operations at
    ``ops`` (ms from ``t0``), its busy time from its own union."""
    td = object.__new__(TraceData)
    td.t0, td.t1 = t0, t0 + 100 * MS
    td.window_s = 0.1
    td.device_ops = [("k", t0 + a * MS, (b - a) * MS, 0) for a, b in ops]
    td.busy_s = td._busy()
    td.spans = []
    return td


def _tracer_with(t0, spans):
    from repro_torch import obs

    tr = obs.Tracer(clock=obs.EpochClock())
    for name, a, b in spans:
        tr.add_span(name, (t0 + a * MS) / 1e9, (t0 + b * MS) / 1e9, "db",
                    "db", 1, 99)
    return tr


def _read(td):
    ctx = Ctx(None, None, None, td)
    return {m: R.load_reader(m).read(ctx) for m in
            SPAN_READERS + IDLE_READERS + ("idle_share.search",)}


def test_idle_split_adds_up_to_the_idle_share(monkeypatch):
    """Device busy 10-30 and 60-70 ms of 100: idle 70 %. The DB's spans
    (one cut by the sub-window's close, one before it) are open 5-40,
    50-55 and 95-100 ms inside it, 25 ms of them with the device idle."""
    from repro_torch import obs

    t0 = time.time_ns()
    td = _trace_data(t0, [(10, 20), (15, 30), (60, 70)])
    monkeypatch.setattr(obs, "PROCESS_TRACER", _tracer_with(t0, [
        ("db.search", 5, 40), ("db.main", 12, 18), ("db.insert", 50, 55),
        ("db.remove", 95, 110), ("db.search", -10, -5)]))
    got = _read(td)
    assert got["idle_share.search"] == pytest.approx(70.0)
    # the spans' float seconds since the epoch hold about 0.24 us
    assert got["idle_in_db_share"] == pytest.approx(25.0, abs=1e-3)
    assert got["idle_outside_db_share"] == pytest.approx(45.0, abs=1e-3)
    assert got["idle_in_db_share"] + got["idle_outside_db_share"] == \
        pytest.approx(got["idle_share.search"], abs=1e-9)
    assert got["db_write_ms"] == pytest.approx(5.0, abs=1e-3)


def test_nothing_to_read_gives_none(monkeypatch):
    """No program span in the sub-window, or a program without the process
    tracer (the parent of the change that added it): every reader of the
    program's spans gives None, never 0."""
    from repro_torch import obs

    t0 = time.time_ns()
    td = _trace_data(t0, [(10, 20)])
    monkeypatch.setattr(obs, "PROCESS_TRACER",
                        _tracer_with(t0, [("db.search", 150, 160)]))
    got = _read(td)
    assert all(got[m] is None for m in SPAN_READERS + IDLE_READERS)
    assert got["idle_share.search"] == pytest.approx(90.0)
    monkeypatch.delattr(obs, "PROCESS_TRACER")
    got = _read(td)
    assert all(got[m] is None for m in SPAN_READERS + IDLE_READERS)
    assert all(R.load_reader(m).read(Ctx(None, None, None, None)) is None
               for m in SPAN_READERS + IDLE_READERS)


@pytest.mark.cuda
def test_the_benchmarks_cuda_profiler_turns_the_program_spans_on():
    """The traced run's profiler traces the device alone; the program's
    spans are recorded under it all the same, and the idle split adds up
    on the card's own intervals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from ragbench.record import Spans
    from ragbench.trace import Tracer
    from repro_torch import obs
    from repro_torch.core import registry
    from repro_torch.core.interfaces import Chunk

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((4096, 64)).astype(np.float32)
    db = registry.create("vectordb", "torch", index_type="ivf", dim=64,
                         capacity=8192, nlist=16, nprobe=4,
                         flat_capacity=1024, device=dev)
    db.insert(rows, [Chunk(-1, i // 4, "") for i in range(4096)])
    db.build_index()
    db.insert(rows[:8] + 0.01, [Chunk(-1, 5000, "") for _ in range(8)])
    db.search(rows[:32], 8)
    tr = Tracer(SimpleNamespace(device=dev, log=SimpleNamespace(
        spans=Spans())))
    assert obs.active_tracer(None) is None
    tr.start()
    assert obs.active_tracer(None) is obs.PROCESS_TRACER
    for i in range(20):
        db.search(rows[32 * i:32 * i + 32], 8)
    db.remove(5000)
    tr.stop()
    assert obs.active_tracer(None) is None
    td = tr.reduce()
    assert td.device_ops
    got = _read(td)
    for m in SPAN_READERS:
        assert got[m] > 0, m
    assert got["idle_in_db_share"] + got["idle_outside_db_share"] == \
        pytest.approx(got["idle_share.search"], abs=1e-6)
