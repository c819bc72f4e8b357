"""A register key's search work, counted from its history alone: the
same whatever searches it.

A search linearizes one op at a time, so it takes as many steps as ops
must linearize: every :ok op, or on a key the reference refutes one
more than the most it linearized. Each step chooses among the ops
whose invoke-to-return spans overlap, at most ``window`` of them. A
:fail op never happened; an :info op stays open to the end.
"""

from __future__ import annotations

INF = float("inf")


def spans(ops: list) -> list:
    """``(invoke, return, required)`` positions of each op that may
    have taken effect, counting the client ops (integer processes);
    an :info op or one never completed returns at infinity."""
    open_at = {}
    out = []
    pos = 0
    for op in ops:
        proc = op.get("process")
        if not isinstance(proc, int):
            continue
        pos += 1
        if op["type"] == "invoke":
            open_at[proc] = pos
            continue
        start = open_at.pop(proc, None)
        if start is None or op["type"] == "fail":
            continue
        ok = op["type"] == "ok"
        out.append((start, pos if ok else INF, ok))
    return out + [(start, INF, False) for start in open_at.values()]


def steps(ops: list, depth=None) -> int:
    """Ops to linearize: the :ok ops, or at most ``depth + 1`` where
    the reference refutes the key and linearized ``depth`` at most."""
    required = sum(1 for s in spans(ops) if s[2])
    return required if depth is None else min(required, depth + 1)


def window(ops: list) -> int:
    """The most ops whose spans overlap."""
    ss = spans(ops)
    edges = sorted([(a, 1) for a, _, _ in ss]
                   + [(b, -1) for _, b, _ in ss if b != INF])
    width = level = 0
    for _, step in edges:
        level += step
        width = max(width, level)
    return width
