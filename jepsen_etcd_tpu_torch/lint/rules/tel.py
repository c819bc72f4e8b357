"""TEL: telemetry discipline.

The cross-run dashboard joins counters by NAME across runs and
configs; a typo'd counter name silently creates a new series and the
dashboards read zero forever. And a span created but never entered
(``tel.span("x")`` as a bare statement instead of ``with
tel.span("x"):``) records nothing while looking instrumented.

``runner/telemetry.py`` carries the canonical name inventory as a
``REGISTRY`` literal; TEL002 reads it via ``ast.literal_eval`` — the
linter never imports the package. Registry entries may use ``*``
wildcards for parameterized families (``phase:*``,
``stream.*_reuse``).

- TEL001 — span created but not used as a ``with`` context (and not
  stored/returned for the caller to enter): enter/exit imbalance,
  the span is a silent no-op.
- TEL002 — span/counter/event name (or its constant f-string prefix)
  that matches nothing in the registry.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterator, Optional, Tuple

FAMILY = "TEL"

RULES = {
    "TEL001": "span created but never entered (no with-context)",
    "TEL002": "telemetry name not in the runner/telemetry.py REGISTRY",
}

_KIND = {"span": "spans", "counter": "counters", "event": "events",
         "hist": "hists", "hist_many": "hists"}


def _name_arg(node: ast.Call) -> Tuple[Optional[str], bool]:
    """(name-or-prefix, is_prefix) from the first positional arg;
    (None, False) when it isn't string-shaped (e.g. re.Match.span(1))."""
    if not node.args:
        return None, False
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, False
    if isinstance(a, ast.JoinedStr) and a.values \
            and isinstance(a.values[0], ast.Constant) \
            and isinstance(a.values[0].value, str):
        return a.values[0].value, True
    if isinstance(a, ast.BinOp) and isinstance(a.op, ast.Add) \
            and isinstance(a.left, ast.Constant) \
            and isinstance(a.left.value, str):
        return a.left.value, True
    return None, False


def _registered(name: str, is_prefix: bool, entries) -> bool:
    if not is_prefix:
        return any(fnmatch.fnmatchcase(name, e) for e in entries)
    for e in entries:
        head = e.split("*", 1)[0]
        if name.startswith(head) or head.startswith(name):
            return True
    return False


def check(module, ctx) -> Iterator:
    if ctx.policy.registry_module(module.relpath):
        return  # the registry module defines the API; don't self-lint
    registry = ctx.policy.tel_registry
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _KIND:
            continue
        name, is_prefix = _name_arg(node)
        if name is None:
            continue  # not the telemetry signature (re.Match.span etc)

        if node.func.attr == "span":
            parent = module.parent(node)
            entered = isinstance(parent, ast.withitem) or \
                isinstance(parent, (ast.Assign, ast.AnnAssign,
                                    ast.Return, ast.NamedExpr))
            if not entered:
                yield module.finding(
                    "TEL001", node,
                    f"span {name!r} is created but never entered; use "
                    "`with tel.span(...):` (or store/return it for the "
                    "caller to enter)")

        if registry is not None:
            entries = registry.get(_KIND[node.func.attr], ())
            if not _registered(name, is_prefix, entries):
                what = "prefix" if is_prefix else "name"
                yield module.finding(
                    "TEL002", node,
                    f"{node.func.attr} {what} {name!r} is not in the "
                    "runner/telemetry.py REGISTRY; dashboards join by "
                    "name — register it or fix the typo")
