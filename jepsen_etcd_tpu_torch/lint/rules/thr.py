"""THR: thread-safety discipline.

The deterministic core is single-threaded by construction, but two
real thread boundaries exist: the StreamFeed worker (checker thread
overlapping generation) and the wall-time bridge / live-client reader
threads. The invariant on those surfaces is: shared mutable state
crosses a thread boundary only under a Lock/Condition or through a
Queue/Event. A bare ``self.x = ...`` from a worker races with the
main loop's read — exactly the withdrawal race class the stream
finalize handshake guards against.

Scope: only modules that actually construct ``threading.Thread``.
Worker code = the ``target=`` functions plus everything they call by
simple name inside the same module.

- THR001 — write to a shared ``self.*`` attribute from worker code
  with no enclosing lock ``with`` block, when the attribute is also
  touched outside the worker (the shared surface).
- THR002 — ``global`` rebinding inside worker code: module globals
  have no lock at all.
"""

from __future__ import annotations

import ast
from typing import Iterator

FAMILY = "THR"

RULES = {
    "THR001": "unsynchronized shared-attribute write from a worker "
              "thread",
    "THR002": "module-global rebinding from a worker thread",
}

_LOCKISH = ("lock", "cond", "cv", "mutex")


def _worker_entry_names(tree: ast.AST) -> set:
    """Simple names handed to ``threading.Thread(target=...)``."""
    out: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        leaf = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if leaf != "Thread":
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            if isinstance(v, ast.Name):
                out.add(v.id)
            elif isinstance(v, ast.Attribute):
                out.add(v.attr)
    return out


def _called_names(fn: ast.AST) -> set:
    """Bare-name and ``self.x()`` calls only: ``other.finish()`` must
    not pull an unrelated same-named method into the worker set."""
    out: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "self":
                out.add(f.attr)
    return out


def _worker_functions(module, entries: set) -> list:
    """Defs reachable from the Thread targets by simple name within
    this module (over-approximate: name match, any class)."""
    defs = [n for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    by_name: dict = {}
    for d in defs:
        by_name.setdefault(d.name, []).append(d)
    frontier = list(entries)
    seen: set = set()
    workers = []
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for d in by_name.get(name, ()):
            workers.append(d)
            frontier.extend(_called_names(d) - seen)
    return workers


def _under_lock(module, node: ast.AST) -> bool:
    """Any enclosing ``with`` whose context expression names something
    lock-like (lock/cond/cv/mutex) — the Condition/Lock discipline."""
    cur = module.parent(node)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                txt = ast.unparse(item.context_expr).lower()
                if any(k in txt for k in _LOCKISH):
                    return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        cur = module.parent(cur)
    return False


def _self_attr_targets(stmt: ast.AST):
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    for t in targets:
        for node in ast.walk(t):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                yield node


def check(module, ctx) -> Iterator:
    entries = _worker_entry_names(module.tree)
    if ctx.policy.all_in_scope and not entries:
        # fixtures may name the worker conventionally
        entries = {"_worker", "worker", "run"} & {
            n.name for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    if not entries:
        return
    workers = _worker_functions(module, entries)
    worker_nodes = set()
    for w in workers:
        for n in ast.walk(w):
            worker_nodes.add(n)

    # the shared surface: self-attrs touched OUTSIDE worker code too
    outside_attrs: set = set()
    for node in ast.walk(module.tree):
        if node in worker_nodes:
            continue
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            outside_attrs.add(node.attr)

    for w in workers:
        for stmt in ast.walk(w):
            if isinstance(stmt, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                for attr_node in _self_attr_targets(stmt):
                    if attr_node.attr not in outside_attrs:
                        continue
                    if _under_lock(module, stmt):
                        continue
                    yield module.finding(
                        "THR001", stmt,
                        f"self.{attr_node.attr} is written from the "
                        f"worker thread ({w.name}) without a lock but "
                        "is also touched from the main thread; hold "
                        "the Condition/Lock or hand the value over a "
                        "Queue")
            elif isinstance(stmt, ast.Global):
                yield module.finding(
                    "THR002", stmt,
                    f"worker thread ({w.name}) rebinds module "
                    f"global(s) {', '.join(stmt.names)}; globals have "
                    "no lock — use an instance attribute under the "
                    "worker's Condition")
