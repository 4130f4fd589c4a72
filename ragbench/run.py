"""Run one cell of the benchmark once.

    python3 ragbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's deployment on the port (``repro_torch``) from the seed,
warms every shape its traffic uses, measures for ``--seconds``, checks
what the window produced against the plain reference, and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each compared number beside its limit (also the last
lines of standard error). Exits non-zero without a result where the card
is missing or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this folder heads the path; its module names (``trace``)
# must not shadow the standard library's
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "ragbench"]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_paths() -> None:
    """The checkout's ``src`` and root on the path; every cache under the
    checkout's ``build/``, at fixed paths."""
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    path = ROOT / "ragbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "ragbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = T_START, control: bool = False):
    """One run of ``cell``: its result line's object, and the control's
    numbers where ``control`` (``ragbench/control.py``)."""
    import torch

    from ragbench import check, deploy, drive
    from ragbench.metrics._lib import Ctx
    from ragbench.trace import Tracer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    dep = deploy.build(cell, seed, dev)
    tracer = None
    if trace:
        tracer = Tracer(dep)
        tracer.install()
    drive.warm(dep)
    setup_s = time.perf_counter() - t_start
    hook = None
    if tracer is not None:
        calls = cell.mix["trace"]["calls"]

        def hook(w):
            # from a third of the window, ``calls`` searches
            time.sleep(max(0.0, w.t0 + seconds / 3 - time.perf_counter()))
            n0 = len(dep.log.searches)
            tracer.start()
            while (len(dep.log.searches) - n0 < calls
                   and time.perf_counter() < w.t1):
                time.sleep(0.002)
            tracer.stop()
    win = drive.search_window(dep, seconds, hook)
    if tracer is not None and tracer.prof is not None:
        tracer.stop()
    if cuda:
        torch.cuda.synchronize(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    metrics = {}
    breakdown = None
    busy = None
    done = win.done_in_window("search")
    if not trace:
        vals = {"search_qps": (sum(r["n"] for r in done) / seconds,
                               "queries/s"),
                "setup_s": (setup_s, "s")}
        for name in cell.metric_names(False):
            if name in vals:
                metrics[name] = {"value": vals[name][0],
                                 "unit": vals[name][1]}
    else:
        td = tracer.reduce() if tracer.done else None
        tracer.uninstall()
        ctx = Ctx(cell, win, dep.log, td)
        for entry in cell.per_layer:
            name = entry["name"]
            if name not in cell.metric_names(True):
                continue
            val = load_reader(name).read(ctx)
            if val is not None:
                metrics[name] = {"value": float(val), "unit": entry["unit"]}
        if td is not None:
            breakdown = td.breakdown()
            busy = (td.busy_s, td.window_s)
            print(f"trace: {len(td.device_ops)} device operations, "
                  f"{td.n_launch_events} runtime calls, {td.matched} "
                  f"matched, {len(td.spans)} spans", file=sys.stderr)
        tracer = td = ctx = None
    ops = {}
    for r in win.requests:
        ops[r["op"]] = ops.get(r["op"], 0) + 1
    sixths = [0] * 6
    for r in done:
        sixths[min(5, int(6 * (r["end"] - win.t0) / seconds))] += r["n"]
    print(f"window: requests {ops}; queries/s in each sixth "
          f"{[round(6 * q / seconds) for q in sixths]}", file=sys.stderr)
    cap = check.capture(dep)
    check.free(dep)
    nums, cnums = check.judge(dep, cap, win, control)
    correct, checks = check.verdict(nums, cell.limits)
    out = {"correct": correct, "attempted": int(win.attempted),
           "failed": int(win.failed), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else "cpu", "count": cell.chips,
                      "memory_peak_bytes": peak}}
    if busy is not None:
        out["device"]["busy_s"], out["device"]["window_s"] = busy
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["numbers"] = nums
    print(f"set-up: {json.dumps(dep.timings)}; judged: {json.dumps(nums)}",
          file=sys.stderr)
    return out, cnums


def result_line(out) -> str:
    """The result's JSON line, ``checks`` last; the checks' lines go to
    standard error first, as the last lines there."""
    out = {k: v for k, v in out.items() if k != "numbers"}
    out["checks"] = out.pop("checks")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return json.dumps(out)


def emit(out) -> int:
    """Print the result line, or refuse (no result) where JAX or the JAX
    package was loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"refused: sys.modules holds {', '.join(bad)}", file=sys.stderr)
        return 4
    print(result_line(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_paths()
    from ragbench.cell import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"refused: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out, _ = run(cell, args.seed, args.seconds, bool(args.trace))
    return emit(out)


if __name__ == "__main__":
    sys.exit(main())
