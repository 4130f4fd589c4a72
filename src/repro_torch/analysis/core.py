"""Shared machinery for the port's invariant linter (the twin of the
reference's ``analysis.core``, scanning ``src/repro_torch``).

A *pass* is a module exposing ``PASS`` (its name) and
``run(files, root) -> list[Finding]``.  This module owns everything the
passes share: parsed source files with their comment map (the annotation
grammar lives in comments, so the AST alone is not enough), ``# noqa``
suppression, and the committed-baseline diff that lets CI fail only on
findings not already acknowledged.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PASS_NAMES = ("clock-purity", "lock-discipline", "conformance", "gauge-schema")

#: Directories scanned by default, relative to the repo root.
DEFAULT_SCAN_DIRS = ("src/repro_torch",)

#: The port's committed baseline, relative to the repo root. It stays empty:
#: a finding in the port is repaired, not acknowledged.
BASELINE_NAME = "src/repro_torch/analysis/baseline.json"


@dataclass(frozen=True)
class Finding:
    """One linter finding, keyed without line numbers so the committed
    baseline survives unrelated edits above the offending line."""

    pass_id: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str

    def key(self) -> str:
        return f"{self.pass_id}::{self.path}::{self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"pass": self.pass_id, "path": self.path,
                "line": self.line, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"


_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<passes>[\w, -]+))?")


class SourceFile:
    """A parsed source file plus its per-line comment map.

    ``tokenize`` (not the AST) is the only way to see comments, and all
    three annotation kinds -- ``# guarded-by:``, ``# locked-by:``,
    ``# deterministic`` -- plus ``# noqa`` suppressions live in comments.
    """

    def __init__(self, root: str, abs_path: str):
        self.abs_path = abs_path
        self.rel_path = os.path.relpath(abs_path, root).replace(os.sep, "/")
        with open(abs_path, encoding="utf-8") as f:
            self.text = f.read()
        self.tree = ast.parse(self.text, filename=self.rel_path)
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass

    def comment(self, line: int) -> str:
        return self.comments.get(line, "")

    def comment_in_stmt(self, node: ast.AST) -> str:
        """First comment on any physical line a (possibly wrapped)
        statement spans -- annotations sit on whichever line fits."""
        end = getattr(node, "end_lineno", None) or node.lineno
        for ln in range(node.lineno, end + 1):
            c = self.comments.get(ln, "")
            if c:
                return c
        return ""

    def suppressed(self, line: int, pass_id: str) -> bool:
        m = _NOQA_RE.search(self.comments.get(line, ""))
        if not m:
            return False
        passes = m.group("passes")
        if passes is None:
            return True  # bare ``# noqa`` silences every pass
        names = {p.strip() for p in re.split(r"[,\s]+", passes) if p.strip()}
        return pass_id in names


def iter_source_files(root: str,
                      paths: Optional[Sequence[str]] = None) -> List[SourceFile]:
    """Parse the scan set; files that fail to parse are skipped (the
    interpreter/pytest will complain about those far more loudly)."""
    abs_paths: List[str] = []
    if paths is not None:
        abs_paths = [p if os.path.isabs(p) else os.path.join(root, p)
                     for p in paths]
    else:
        for d in DEFAULT_SCAN_DIRS:
            base = os.path.join(root, d)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [dn for dn in dirnames
                               if dn != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        abs_paths.append(os.path.join(dirpath, fn))
    out: List[SourceFile] = []
    for p in sorted(set(abs_paths)):
        try:
            out.append(SourceFile(root, p))
        except (OSError, SyntaxError, ValueError):
            continue
    return out


def run_passes(root: str,
               paths: Optional[Sequence[str]] = None,
               passes: Optional[Sequence[str]] = None,
               ) -> Tuple[List[Finding], int]:
    """Run the requested static/dynamic passes over the scan set.

    Returns ``(findings, n_suppressed)`` where findings already exclude
    ``# noqa``-suppressed lines.
    """
    from repro_torch.analysis import (clock_purity, conformance,
                                      gauge_schema, lock_discipline)
    registry = {m.PASS: m for m in
                (clock_purity, lock_discipline, conformance, gauge_schema)}
    selected = list(passes) if passes else list(PASS_NAMES)
    unknown = [p for p in selected if p not in registry]
    if unknown:
        raise ValueError(f"unknown pass(es): {', '.join(unknown)} "
                         f"(known: {', '.join(PASS_NAMES)})")

    files = iter_source_files(root, paths)
    by_rel = {sf.rel_path: sf for sf in files}

    raw: List[Finding] = []
    for name in selected:
        raw.extend(registry[name].run(files, root))

    findings: List[Finding] = []
    n_suppressed = 0
    for f in raw:
        sf = by_rel.get(f.path)
        if sf is not None and sf.suppressed(f.line, f.pass_id):
            n_suppressed += 1
            continue
        findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id, f.message))
    return findings, n_suppressed


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> Set[str]:
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    keys: Set[str] = set()
    for e in data.get("findings", []):
        keys.add(f"{e['pass']}::{e['path']}::{e['message']}")
    return keys


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    entries = []
    seen: Set[str] = set()
    for f in sorted(findings, key=lambda f: f.key()):
        if f.key() in seen:
            continue
        seen.add(f.key())
        entries.append({"pass": f.pass_id, "path": f.path,
                        "message": f.message})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"findings": entries}, f, indent=2, sort_keys=True)
        f.write("\n")


def new_findings(findings: Sequence[Finding],
                 baseline: Set[str]) -> List[Finding]:
    return [f for f in findings if f.key() not in baseline]
