"""lock-discipline pass: guarded fields are only touched under their lock.

Grammar (comments, matched per physical line of the declaration):

- ``self.field = ... # guarded-by: _lock`` in ``__init__`` declares that
  every later ``self.field`` read/write in the class must happen inside a
  ``with self._lock:`` block.  Dataclass class-body field lines take the
  same annotation.
- ``def method(self): # locked-by: _lock`` declares that *callers* hold
  the lock, so the method body is checked as if the lock were held.

Semantics the checker enforces:

- ``__init__`` is exempt (no concurrent access before construction ends).
- A nested ``def``/``lambda`` resets the held set: its body runs at some
  later call time when the enclosing ``with`` has long exited.  Monitor
  gauge lambdas are the canonical case -- intentional lock-free reads
  there need an explicit ``# noqa: lock-discipline`` with justification.
- Only ``self.<field>`` accesses inside the declaring class are checked;
  cross-object accesses (``other._x``) are out of scope.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from repro_torch.analysis.core import Finding, SourceFile

PASS = "lock-discipline"

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")
_LOCKED_RE = re.compile(r"#\s*locked-by:\s*(\w+)")


def _self_attr(node: ast.AST) -> str:
    """'attr' if node is ``self.attr``, else ''."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return ""


def _guarded_fields(sf: SourceFile, cls: ast.ClassDef) -> Dict[str, str]:
    guarded: Dict[str, str] = {}
    # dataclass-style class-body declarations
    for stmt in cls.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            m = _GUARD_RE.search(sf.comment_in_stmt(stmt))
            if not m:
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    guarded[t.id] = m.group(1)
    # __init__ self-assignments
    for meth in cls.body:
        if isinstance(meth, ast.FunctionDef) and meth.name == "__init__":
            for stmt in ast.walk(meth):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                m = _GUARD_RE.search(sf.comment_in_stmt(stmt))
                if not m:
                    continue
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr:
                        guarded[attr] = m.group(1)
    return guarded


class _Checker:
    def __init__(self, sf: SourceFile, cls: ast.ClassDef,
                 guarded: Dict[str, str], method: str):
        self.sf, self.cls = sf, cls
        self.guarded, self.method = guarded, method
        self.findings: List[Finding] = []

    def visit(self, node: ast.AST, held: Set[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                self.visit(item.context_expr, held)
                if item.optional_vars is not None:
                    self.visit(item.optional_vars, held)
                attr = _self_attr(item.context_expr)
                if attr:
                    inner.add(attr)
            for stmt in node.body:
                self.visit(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # defaults evaluate now, under the current held set ...
            for d in list(node.args.defaults) + [d for d in
                                                 node.args.kw_defaults if d]:
                self.visit(d, held)
            # ... the body runs later, when no lock from here is held
            inner: Set[str] = set()
            m = None
            if not isinstance(node, ast.Lambda):
                m = _LOCKED_RE.search(self.sf.comment(node.lineno))
            if m:
                inner.add(m.group(1))
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                self.visit(stmt, inner)
            return
        if isinstance(node, ast.ClassDef):
            return  # nested class: out of scope
        attr = _self_attr(node)
        if attr and attr in self.guarded:
            lock = self.guarded[attr]
            if lock not in held:
                self.findings.append(Finding(
                    PASS, self.sf.rel_path, node.lineno,
                    f"{self.cls.name}.{attr} accessed outside "
                    f"'with self.{lock}' (in {self.method})"))
            return  # the Name 'self' below carries no extra information
        for child in ast.iter_child_nodes(node):
            self.visit(child, held)


def _check_class(sf: SourceFile, cls: ast.ClassDef) -> List[Finding]:
    guarded = _guarded_fields(sf, cls)
    if not guarded:
        return []
    out: List[Finding] = []
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name == "__init__":
            continue
        held: Set[str] = set()
        m = _LOCKED_RE.search(sf.comment(meth.lineno))
        if m:
            held.add(m.group(1))
        ck = _Checker(sf, cls, guarded, meth.name)
        for stmt in meth.body:
            ck.visit(stmt, held)
        out.extend(ck.findings)
    return out


def run(files: List[SourceFile], root: str) -> List[Finding]:
    out: List[Finding] = []
    for sf in files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(_check_class(sf, node))
    return out
