"""COL: columnar discipline.

Direction 1 deleted the per-op dict round-trip from the hot checker
paths; the tier-1 guard ``History.dict_materializations == 0`` catches
a regression only when a test happens to drive the offending path over
a column-only history. COL is the static twin: in modules declared
columnar (policy.COLUMNAR — ops/ and the columnar checkers), touching
the dict-op surface of a History is a finding even if every current
test keeps its histories dict-backed.

- COL001 — materializing dict ops: ``.ops`` / ``.to_ops()`` /
  ``.op_at()``.
- COL002 — dict-backed History APIs (filter/pairing helpers): each one
  walks ``self.ops`` internally, so the materialization is just hidden
  one call deeper.

Guarded fallbacks (``if columns is None: <dict path>``) are the
documented escape hatch — suppress them in place with the reason.
"""

from __future__ import annotations

import ast
from typing import Iterator

FAMILY = "COL"

RULES = {
    "COL001": "dict-op materialization in a columnar module",
    "COL002": "dict-backed History API in a columnar module",
}

_MATERIALIZE_CALLS = {"to_ops", "op_at"}
_DICT_APIS = {"client_ops", "nemesis_ops", "oks", "invokes", "remove_f",
              "filter", "completion", "invocation", "by_index", "pairs"}
#: attribute names whose ``.ops`` access is NOT History.ops
_ATTR_FALSE_FRIENDS = {"self"}


def check(module, ctx) -> Iterator:
    if not ctx.policy.columnar(module.relpath):
        return
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Attribute):
            parent = module.parent(node)
            if node.attr == "ops" and not (
                    isinstance(node.value, ast.Name)
                    and node.value.id in _ATTR_FALSE_FRIENDS):
                yield module.finding(
                    "COL001", node,
                    ".ops materializes one dict per op "
                    "(History.dict_materializations); consume the SoA "
                    "columns instead")
            elif node.attr in _MATERIALIZE_CALLS and \
                    isinstance(parent, ast.Call) and parent.func is node:
                yield module.finding(
                    "COL001", node,
                    f".{node.attr}() materializes dict ops; consume "
                    "the SoA columns instead")
            elif node.attr in _DICT_APIS and (
                    (isinstance(parent, ast.Call) and parent.func is node)
                    or node.attr == "pairs"):
                yield module.finding(
                    "COL002", node,
                    f"History.{node.attr} walks the dict op list "
                    "internally; use the columnar accessors "
                    "(client_pairs, split_by_key, typed arrays)")
