"""Readings for the correctness limits: on each seed, a run of the cell
with its program numbers and its control's (the reference one precision
below the configuration's, in the program's place), one JSON line a seed.

    python3 ragbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--fault kmeans]

The seeds run in one process, each with its own deployment; this is not a
benchmark run (its set-up times mean nothing), and it needs the card.
``--fault kmeans`` plants a fault in the program for its readings: the IVF
index's k-means stops after one round (a barely trained index).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ragbench import run as R  # noqa: E402


def plant_kmeans_fault(rounds: int = 1) -> None:
    """The program's k-means cut to ``rounds`` rounds, whatever it is
    asked for."""
    from repro_torch.core import vectordb

    kmeans = vectordb.kmeans

    def cut(x, k, iters=10, seed=0, init=None):
        return kmeans(x, k, min(iters, rounds), seed, init)

    vectordb.kmeans = cut


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("kmeans",))
    args = ap.parse_args(argv)
    R.setup_paths()
    if args.fault == "kmeans":
        plant_kmeans_fault()
    from ragbench.cell import load_cell

    cell = load_cell(args.workload, tiny=args.device == "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out, ctl = R.run(cell, seed, args.seconds, False, args.device,
                         t_start=t0, control=True)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "fault": args.fault,
                          "correct": out["correct"],
                          "program": out["numbers"],
                          "control": {k: float(v) for k, v in ctl.items()},
                          "metrics": out["metrics"],
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
