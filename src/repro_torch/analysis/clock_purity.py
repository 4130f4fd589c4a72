"""clock-purity pass: no wall clock / unseeded randomness in deterministic
zones.

A *deterministic zone* is declared with comments:

- ``# analysis: deterministic`` anywhere in a module marks the whole file;
- ``# deterministic`` trailing a ``def``/``class`` line marks that subtree.

Inside a zone, calls resolving (through import aliases) to the wall clock
(``time.time``/``perf_counter``/``sleep``/...), calendar time
(``datetime.now``/``utcnow``/``today``), the process-global RNGs
(``random.random``, ``numpy.random.rand``, ...) or *unseeded* RNG
constructors (``random.Random()``, ``np.random.default_rng()`` with no
arguments) are findings.  Seeded constructors are allowed.  Calls into
``torch`` are outside the pass, as ``jax.random`` is in the reference's:
the port's deterministic zones draw from explicit, seeded
``torch.Generator`` objects.  The rules are the reference's, so both
passes report the same findings on the same files.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from repro_torch.analysis.core import Finding, SourceFile

PASS = "clock-purity"

_MODULE_PRAGMA_RE = re.compile(r"#\s*analysis:\s*deterministic\b")
_ZONE_MARK_RE = re.compile(r"#\s*deterministic\b")

BANNED = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
    "random.SystemRandom",  # OS entropy: unseedable by definition
}

#: RNG constructors that are fine when (and only when) given a seed.
SEEDABLE_CTORS = {
    "random.Random",
    "numpy.random.default_rng", "numpy.random.RandomState",
    "numpy.random.Generator", "numpy.random.SeedSequence",
    "numpy.random.PCG64", "numpy.random.Philox", "numpy.random.MT19937",
}


def _alias_map(tree: ast.Module) -> Dict[str, str]:
    """Map local names to canonical dotted paths (``np`` -> ``numpy``,
    ``perf_counter`` -> ``time.perf_counter``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom):
            if node.level or not node.module:
                continue  # relative imports never reach time/random/numpy
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _resolve(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical dotted path of a call target, or None if it does not root
    in an imported name (locals shadowing ``time`` etc. stay silent)."""
    if isinstance(node, ast.Name):
        return aliases.get(node.id)
    if isinstance(node, ast.Attribute):
        base = _resolve(node.value, aliases)
        if base is None:
            return None
        return f"{base}.{node.attr}"
    return None


def _zone_roots(sf: SourceFile) -> List[ast.AST]:
    if any(_MODULE_PRAGMA_RE.search(c) for c in sf.comments.values()):
        return [sf.tree]
    roots: List[ast.AST] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if _ZONE_MARK_RE.search(sf.comment(node.lineno)):
                roots.append(node)
    return roots


def _check_call(sf: SourceFile, call: ast.Call,
                aliases: Dict[str, str]) -> Optional[Finding]:
    full = _resolve(call.func, aliases)
    if full is None:
        return None
    if full in BANNED:
        return Finding(PASS, sf.rel_path, call.lineno,
                       f"{full}() called in deterministic zone")
    if full in SEEDABLE_CTORS:
        if not call.args and not call.keywords:
            return Finding(PASS, sf.rel_path, call.lineno,
                           f"unseeded {full}() in deterministic zone")
        return None
    # Any other module-level function on the process-global RNGs: the
    # global state makes the result depend on call order across the
    # whole process, which replay cannot pin down.
    for prefix in ("random.", "numpy.random."):
        if full.startswith(prefix):
            return Finding(
                PASS, sf.rel_path, call.lineno,
                f"{full}() uses the process-global RNG in deterministic "
                f"zone (seed an explicit Generator instead)")
    return None


def run(files: List[SourceFile], root: str) -> List[Finding]:
    out: List[Finding] = []
    for sf in files:
        roots = _zone_roots(sf)
        if not roots:
            continue
        aliases = _alias_map(sf.tree)
        seen: set = set()
        for zone in roots:
            for node in ast.walk(zone):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                f = _check_call(sf, node, aliases)
                if f is not None:
                    out.append(f)
    return out
