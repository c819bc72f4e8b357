"""DET: determinism rules.

The whole correctness story of this port rests on bit-identical
replays: same seed, same history, same verdict (the 9-config
golden-hash bar, PERF.md §gen). These rules prove the three classic
leak paths are closed at parse time:

- DET001 — wall-clock reads reachable from sim/verdict code. Virtual
  time is the only clock the deterministic core may observe; the
  WallLoop/telemetry allowlist (policy.DET_WALLCLOCK_ALLOW) carries
  the modules that measure *host* cost by design.
- DET002 — unseeded module-level randomness. Every random draw must
  come through a seeded ``random.Random`` / ``np.random.default_rng``
  instance (the SimLoop owns one); ``random.random()`` or
  ``np.random.rand()`` silently forks the history from its seed.
- DET003 — hash/id-ordered iteration escaping: iterating a set (or
  coercing one to a sequence) without ``sorted``, and ``id()`` used as
  a key — str hashes are randomized per process, id() is allocation
  order; both leak arbitrary order into histories or verdicts.
"""

from __future__ import annotations

import ast
from typing import Iterator

FAMILY = "DET"

RULES = {
    "DET001": "wall-clock call reachable from sim/verdict code",
    "DET002": "unseeded module-level randomness",
    "DET003": "hash- or id-ordered data escaping into results",
}

#: dotted origins that read the wall clock
_WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

#: module-level random draws (the seeded-instance API is fine)
_RANDOM_MODULES = ("random", "numpy.random")
_RANDOM_OK = {"Random", "SystemRandom", "default_rng", "Generator",
              "RandomState", "seed"}

_SEQ_COERCE = {"list", "tuple", "iter", "enumerate"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def check(module, ctx) -> Iterator:
    policy = ctx.policy
    wallclock_ok = policy.wallclock_allowed(module.relpath)
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            origin = module.origin(node.func)
            # DET001 wall clock
            if origin in _WALL_CLOCK and not wallclock_ok \
                    and ctx.reachable(module, node):
                yield module.finding(
                    "DET001", node,
                    f"wall-clock call {origin}() reachable from "
                    "sim/verdict code; use the loop's virtual clock, or "
                    "move host-cost timing behind the telemetry "
                    "allowlist")
            # DET002 unseeded randomness (anywhere in the package —
            # there is no benign place for an unseeded draw)
            if origin is not None:
                head, _, leaf = origin.rpartition(".")
                if head in _RANDOM_MODULES and leaf not in _RANDOM_OK:
                    yield module.finding(
                        "DET002", node,
                        f"module-level {origin}() draws from unseeded "
                        "global state; use a seeded Random/Generator "
                        "instance (the SimLoop owns loop.rng)")
            # DET003b id() as a key
            if isinstance(node.func, ast.Name) and node.func.id == "id" \
                    and len(node.args) == 1 \
                    and ctx.reachable(module, node):
                yield module.finding(
                    "DET003", node,
                    "id() is allocation order and can alias after GC; "
                    "key on a stable identity instead")
            # DET003a sequence coercion of a set
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _SEQ_COERCE and node.args \
                    and _is_set_expr(node.args[0]) \
                    and ctx.reachable(module, node):
                yield module.finding(
                    "DET003", node,
                    f"{node.func.id}() over a set fixes an arbitrary "
                    "hash order; wrap in sorted() if the order can "
                    "reach a history or verdict")
        elif isinstance(node, (ast.For, ast.AsyncFor)) \
                and _is_set_expr(node.iter) \
                and ctx.reachable(module, node):
            yield module.finding(
                "DET003", node,
                "iterating a set in hash order; wrap in sorted() if "
                "the order can reach a history or verdict")
        elif isinstance(node, ast.comprehension) \
                and _is_set_expr(node.iter) \
                and ctx.reachable(module, node.iter):
            yield module.finding(
                "DET003", node.iter,
                "comprehension over a set in hash order; wrap in "
                "sorted() if the order can reach a history or verdict")
