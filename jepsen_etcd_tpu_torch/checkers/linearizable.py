"""Linearizability checking: the CPU reference oracle (WGL).

The reference delegates to Knossos (``checker/linearizable {:model ...}``,
register.clj:110-112, lock.clj:244). This module is our CPU
re-implementation of the Wing-Gong/Lowe search — it is the *oracle* the
device kernel (ops/wgl_mxu.py) is differentially tested against, and
the fallback when a history exceeds kernel capacity. (A copy of the
reference's ``checkers/linearizable.py``.)

Semantics (matching Knossos):
- :ok ops must linearize, using the completion's value (reads learn their
  value at completion);
- :info ops (indefinite) may linearize at any point after their invoke, or
  never (the client may or may not have taken effect); their value is the
  invocation's;
- :fail ops definitely did not happen and are excluded.

Search: depth-first over configurations (linearized-mask, model-state)
with a visited-set memo — Lowe's "just-in-time linearization". The WGL
candidate rule: an op may be linearized next only if it was invoked before
the earliest return among unlinearized ops that must linearize (nothing
can be deferred past a completed op's return).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..core.op import Op
from ..core.history import History
from ..models.base import Model, Inconsistent
from ..runner import telemetry
from .core import Checker

INF = float("inf")


@dataclass
class Entry:
    """One logical operation for the search."""

    i: int          # dense id (bit position)
    f: str
    value: Any
    invoke: int     # total order position of invocation
    ret: float      # total order position of return (INF for :info)
    required: bool  # must linearize (ok) vs may (info)
    op: Op          # original invoke op (for reporting)


def history_entries(history) -> Optional[list[Entry]]:
    """Extract completed client operations; None means malformed.

    Hot path: called once per key by every engine (native DFS, device
    kernels, Python oracle), so the loop reads each op's type/process
    exactly once through plain dict access rather than the Op
    predicate properties (measured ~2x on the batched key-DP axis)."""
    h = history if isinstance(history, History) else History(history)
    entries: list[Entry] = []
    open_by_process: dict[Any, tuple[int, Op]] = {}
    pos = 0
    append = entries.append
    for op in h:
        proc = op.get("process")
        if not isinstance(proc, int):
            continue
        pos += 1
        t = op.get("type")
        if t == "invoke":
            open_by_process[proc] = (pos, op)
            continue
        got = open_by_process.pop(proc, None)
        if got is None or t == "fail":
            continue  # unmatched, or definitely didn't happen
        inv_pos, inv = got
        if t == "ok":
            append(Entry(i=len(entries), f=inv["f"],
                         value=op.get("value"), invoke=inv_pos, ret=pos,
                         required=True, op=inv))
        elif t == "info":
            append(Entry(i=len(entries), f=inv["f"],
                         value=inv.get("value"), invoke=inv_pos, ret=INF,
                         required=False, op=inv))
        else:  # not a completion (ad-hoc type): leave the op open
            open_by_process[proc] = got
    # ops still open at history end: treat as :info (may or may not happen)
    for inv_pos, inv in open_by_process.values():
        append(Entry(
            i=len(entries), f=inv["f"], value=inv.get("value"),
            invoke=inv_pos, ret=INF, required=False, op=inv))
    return entries


def check_history(model: Model, history, max_configs: int = 5_000_000,
                  use_native: bool = True) -> dict:
    """WGL search. Returns {'valid?': bool|'unknown', ...}.

    Models expressible as (versioned) CAS registers run on the native
    C++ engine (native/wgl_oracle.cpp, ~100x this DFS); this Python
    search is the semantic reference the native engine is
    differentially tested against, and the path for other models.
    One ``oracle.dfs`` span a call that has ops to search."""
    entries = history_entries(history)
    n = len(entries)
    if n == 0:
        return {"valid?": True, "configs": 0, "ops": 0}
    with telemetry.current().span("oracle.dfs", ops=n):
        return _search(model, entries, max_configs, use_native)


def _search(model: Model, entries: list, max_configs: int,
            use_native: bool) -> dict:
    """``check_history``'s search over a non-empty ``entries``."""
    n = len(entries)
    if use_native:
        from ..native import oracle as native_oracle
        out = native_oracle.check_entries(model, entries,
                                          max_configs=max_configs)
        if out is not None:
            return out
    full_required = 0
    for e in entries:
        if e.required:
            full_required |= 1 << e.i
    visited: set[tuple[int, Model]] = set()
    configs = 0
    # stack of (mask, model); DFS
    stack: list[tuple[int, Model]] = [(0, model)]
    best_depth = 0
    best_blocked: Optional[list] = None
    while stack:
        mask, state = stack.pop()
        try:
            if (mask, state) in visited:
                continue
            visited.add((mask, state))
        except TypeError:
            # unhashable model state (e.g. a set-valued register):
            # proceed without memoizing — correct, just slower
            pass
        configs += 1
        if configs > max_configs:
            return {"valid?": "unknown", "error": "search budget exceeded",
                    "configs": configs, "ops": n}
        if mask & full_required == full_required:
            return {"valid?": True, "configs": configs, "ops": n,
                    "final-model": repr(state)}
        # candidate rule
        min_ret = INF
        for e in entries:
            if e.required and not (mask >> e.i) & 1 and e.ret < min_ret:
                min_ret = e.ret
        depth = bin(mask).count("1")
        blocked_here = []
        for e in entries:
            if (mask >> e.i) & 1:
                continue
            if e.invoke >= min_ret:
                continue
            nxt = state.step(e)
            if isinstance(nxt, Inconsistent):
                if e.required:
                    blocked_here.append((e, nxt.msg))
                # info ops may simply never linearize
                continue
            stack.append((mask | (1 << e.i), nxt))
        if depth >= best_depth and blocked_here:
            best_depth = depth
            best_blocked = blocked_here
    info = {"valid?": False, "configs": configs, "ops": n}
    if best_blocked:
        e, msg = best_blocked[0]
        info["op"] = dict(e.op)
        info["error"] = msg
        info["max-linearized"] = best_depth
    return info


class LinearizableChecker(Checker):
    """checker/linearizable: CPU oracle (use TPUlinearizable for scale)."""

    def __init__(self, model_fn, max_configs: int = 5_000_000):
        self.model_fn = model_fn
        self.max_configs = max_configs

    def check(self, test, history, opts=None) -> dict:
        return check_history(self.model_fn(), history,
                             max_configs=self.max_configs)


def linearizable(model_fn) -> LinearizableChecker:
    return LinearizableChecker(model_fn)
