"""CLI for the port's invariant linter.

::

    PYTHONPATH=src python -m repro_torch.analysis            # report findings
    PYTHONPATH=src python -m repro_torch.analysis --check    # CI gate: exit 2
                                                             # on NEW findings
    PYTHONPATH=src python -m repro_torch.analysis --json     # machine-readable
    PYTHONPATH=src python -m repro_torch.analysis --update-baseline

The baseline (``src/repro_torch/analysis/baseline.json``) records
acknowledged findings keyed by (pass, file, message) -- no line numbers,
so it survives unrelated edits.  ``--check`` fails only on findings not
in the baseline.  The port's baseline is empty and stays so: a finding in
the port is repaired, not acknowledged.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.core import (BASELINE_NAME, PASS_NAMES,
                                       load_baseline, new_findings,
                                       run_passes, save_baseline)


def default_root() -> str:
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, "src", "repro_torch")):
        return cwd
    here = os.path.dirname(os.path.abspath(__file__))  # src/repro_torch/analysis
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter (see docs/analysis.md)")
    ap.add_argument("--check", action="store_true",
                    help="exit 2 if any finding is not in the baseline")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the full report as JSON")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings as the new baseline")
    ap.add_argument("--baseline", default="",
                    help=f"baseline path (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--root", default="", help="repo root to scan")
    ap.add_argument("--passes", default="",
                    help=f"comma-separated subset of: {', '.join(PASS_NAMES)}")
    ap.add_argument("paths", nargs="*",
                    help="explicit files to scan (default: src/repro_torch)")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else default_root()
    passes = [p.strip() for p in args.passes.split(",") if p.strip()] or None
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)

    try:
        findings, n_suppressed = run_passes(
            root, paths=args.paths or None, passes=passes)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.update_baseline:
        save_baseline(baseline_path, findings)
        print(f"baseline updated: {baseline_path} "
              f"({len(findings)} finding(s))")
        return 0

    baseline = load_baseline(baseline_path)
    new = new_findings(findings, baseline)

    if args.as_json:
        print(json.dumps({
            "root": root,
            "passes": passes or list(PASS_NAMES),
            "n_findings": len(findings),
            "n_new": len(new),
            "n_baselined": len(findings) - len(new),
            "n_suppressed": n_suppressed,
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
        }, indent=2))
    else:
        shown = new if args.check else findings
        for f in shown:
            print(f.render())
        print(f"{len(findings)} finding(s): {len(new)} new, "
              f"{len(findings) - len(new)} baselined, "
              f"{n_suppressed} suppressed")

    if args.check and new:
        print(f"FAIL: {len(new)} unbaselined finding(s) -- fix them, "
              f"add '# noqa: <pass>' with justification, or run "
              f"--update-baseline", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
