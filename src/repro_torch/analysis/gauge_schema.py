"""gauge-schema pass: gauge names must belong to a GAUGE_SCHEMA family.

Static sibling of the runtime ``DeprecationWarning`` in
``repro_torch.monitor.monitor.add_gauge``: string keys handed to
``add_gauge``/``add_gauges``/``gauge_set`` calls, and keys built inside
component ``gauges()`` providers, are checked against the port's schema,
``repro_torch.monitor.monitor.gauge_family``, at lint time (the port's
``torch_device_bytes`` stands where the reference has
``jax_device_bytes``).

F-strings are validated by their literal prefix (``f"stage_{name}_ms"``
checks the ``stage_`` family); f-strings with no literal prefix are
skipped -- the runtime warning still covers those.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, SourceFile

PASS = "gauge-schema"

_CALL_NAMES = {"add_gauge", "add_gauges", "gauge_set"}


def _literal_or_prefix(node: ast.AST) -> Optional[Tuple[str, bool]]:
    """(text, is_prefix) for a literal string or f-string key node."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, False
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str):
            prefix = node.values[0].value
            if prefix:
                return prefix, True
        return None
    return None


def _family_ok(name: str, is_prefix: bool) -> bool:
    from repro_torch.monitor.monitor import gauge_family
    if not is_prefix:
        return gauge_family(name) is not None
    # a prefix is fine if any completion of it lands in a family
    return gauge_family(name) is not None or gauge_family(name + "x") is not None


def _check_key(sf: SourceFile, node: ast.AST, context: str,
               seen: Set[Tuple[int, str]], out: List[Finding]) -> None:
    lit = _literal_or_prefix(node)
    if lit is None:
        return
    text, is_prefix = lit
    if _family_ok(text, is_prefix):
        return
    dedup = (node.lineno, text)
    if dedup in seen:
        return
    seen.add(dedup)
    shown = f"{text}..." if is_prefix else text
    out.append(Finding(
        PASS, sf.rel_path, node.lineno,
        f"gauge name '{shown}' ({context}) matches no GAUGE_SCHEMA family"))


def run(files: List[SourceFile], root: str) -> List[Finding]:
    out: List[Finding] = []
    for sf in files:
        if sf.rel_path.endswith("monitor/monitor.py"):
            continue  # the schema's own definition site
        seen: Set[Tuple[int, str]] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                func = node.func
                name = func.attr if isinstance(func, ast.Attribute) else (
                    func.id if isinstance(func, ast.Name) else "")
                if name not in _CALL_NAMES:
                    continue
                if name in ("add_gauge", "gauge_set") and node.args:
                    _check_key(sf, node.args[0], f"{name} call", seen, out)
                elif name == "add_gauges":
                    for arg in list(node.args) + [kw.value for kw
                                                  in node.keywords]:
                        if isinstance(arg, ast.Dict):
                            for k in arg.keys:
                                if k is not None:
                                    _check_key(sf, k, "add_gauges key",
                                               seen, out)
            elif isinstance(node, ast.FunctionDef) and node.name == "gauges":
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Dict):
                        for k in sub.keys:
                            if k is not None:
                                _check_key(sf, k, "gauges() provider key",
                                           seen, out)
                    elif (isinstance(sub, ast.Subscript)
                          and isinstance(sub.ctx, ast.Store)):
                        _check_key(sf, sub.slice, "gauges() provider key",
                                   seen, out)
    return out
