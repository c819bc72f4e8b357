"""Lightweight name-based call-graph reachability.

DET rules must scope by *reachability* ("can SimLoop.run or a checker
``check()`` transitively hit this wall-clock call?"), not by directory
— `serve.py` reading `time.localtime` for a dashboard is fine; the
same call in a workload helper is a determinism hole even though both
live outside `runner/`.

Python call resolution is dynamic, so this graph over-approximates the
safe way: a call to ``foo(...)`` or ``x.foo(...)`` is an edge to EVERY
function or method named ``foo`` in the scanned tree. More reachable
means more scoped — a false edge can only make the lint stricter,
never let a violation escape. Operator tooling (cli/serve/forensics)
stays genuinely unreachable because nothing in the deterministic core
calls into it by any name.

Qualnames are ``module.path:Class.func`` (nested defs chain with
dots); module-level statements own the pseudo-def ``module:<module>``.
"""

from __future__ import annotations

import ast
from collections import deque
from typing import Iterable, Optional

MODULE_SCOPE = "<module>"


class _DefCollector(ast.NodeVisitor):
    """Collect defs + the simple names each def's body calls."""

    def __init__(self, modname: str):
        self.modname = modname
        self.stack: list[str] = []
        # innermost enclosing *function* qualname; class bodies run at
        # definition time in the enclosing scope, so their calls
        # attribute here, not to the class
        self.func_stack: list[str] = []
        # qualname -> set of called simple names
        self.calls: dict[str, set[str]] = {self._qual(MODULE_SCOPE): set()}
        # simple name -> set of qualnames
        self.defs: dict[str, set[str]] = {}
        # ast function node -> qualname (reused by rules for scoping)
        self.qual_of_node: dict[ast.AST, str] = {}

    def _qual(self, leaf: str) -> str:
        return f"{self.modname}:{'.'.join(self.stack + [leaf])}" \
            if self.stack else f"{self.modname}:{leaf}"

    def _current(self) -> str:
        if self.func_stack:
            return self.func_stack[-1]
        return f"{self.modname}:{MODULE_SCOPE}"

    def _visit_def(self, node) -> None:
        qual = self._qual(node.name)
        self.qual_of_node[node] = qual
        self.defs.setdefault(node.name, set()).add(qual)
        self.calls.setdefault(qual, set())
        self.stack.append(node.name)
        self.func_stack.append(qual)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.func_stack.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        name = None
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute):
            name = node.func.attr
        if name:
            self.calls[self._current()].add(name)
        # functions passed by reference (callbacks, Thread targets,
        # graph-captured callables) count as called: their bodies stay reachable
        for arg in list(node.args) + [k.value for k in node.keywords]:
            if isinstance(arg, ast.Name):
                self.calls[self._current()].add(arg.id)
            elif isinstance(arg, ast.Attribute):
                self.calls[self._current()].add(arg.attr)
        self.generic_visit(node)


class CallGraph:
    def __init__(self):
        self.calls: dict[str, set[str]] = {}
        self.defs: dict[str, set[str]] = {}
        self.qual_of_node: dict[ast.AST, str] = {}
        self._reachable: Optional[set[str]] = None

    def add_module(self, modname: str, tree: ast.AST) -> None:
        c = _DefCollector(modname)
        c.visit(tree)
        self.calls.update(c.calls)
        for name, quals in c.defs.items():
            self.defs.setdefault(name, set()).update(quals)
        self.qual_of_node.update(c.qual_of_node)

    def compute_reachable(self, roots: Iterable[str]) -> set[str]:
        """BFS over name-resolved edges from the given qualnames."""
        seen: set[str] = set()
        work = deque(roots)
        while work:
            q = work.popleft()
            if q in seen:
                continue
            seen.add(q)
            for name in self.calls.get(q, ()):
                for target in self.defs.get(name, ()):
                    if target not in seen:
                        work.append(target)
        self._reachable = seen
        return seen

    def reachable(self, qualname: str) -> bool:
        return self._reachable is None or qualname in self._reachable
