"""Aggregate roofline records (``analysis.roofline_report``, one JSON file
each) into a markdown table: the port of ``repro.roofline.report``.

    python -m repro_torch.roofline.report --dir <directory of .json records>

The collective column reads "-" where a record has no collective term (a
one-device step). The default directory is the dry-run's
(``launch.dryrun``'s ``--out``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional


def load_reports(directory: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def fmt_ms(s: Optional[float]) -> str:
    return "-" if s is None else f"{s * 1e3:.1f}"


def markdown_table(reports: List[Dict], multi_pod: bool = False) -> str:
    rows = [r for r in reports if r.get("multi_pod", False) == multi_pod
            and r.get("status") == "ok"]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    hdr = ("| arch | shape | kind | compute ms | memory ms | collective ms | "
           "bottleneck | useful | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {fmt_ms(r['compute_s'])} | {fmt_ms(r['memory_s'])} "
            f"| {fmt_ms(r['collective_s'])} | {r['bottleneck']} "
            f"| {r['useful_flop_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} |")
    return hdr + "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    print(markdown_table(load_reports(args.dir), args.multi_pod))


if __name__ == "__main__":
    main()
