"""Per-key history split for independent (keyed) workloads: the
helpers of the reference's ``generators/independent.py`` that
``History.split_by_key`` falls back to on dict-only histories. The
concurrent key generator itself comes with the simulator slice.

Values of keyed ops are ``(key, value)`` 2-tuples, as
jepsen.independent records them.
"""

from __future__ import annotations


def history_keys(history) -> list:
    """All keys appearing in (key, v) tuple values, in first-seen order."""
    seen: dict = {}
    for op in history:
        v = op.get("value")
        if isinstance(v, tuple) and len(v) == 2:
            seen.setdefault(v[0], None)
    return list(seen)


def subhistory(history, key) -> list:
    """Ops for one key, values unwrapped; preserves op indices."""
    out = []
    for op in history:
        v = op.get("value")
        if isinstance(v, tuple) and len(v) == 2 and v[0] == key:
            out.append(op.evolve(value=v[1]))
    return out


def subhistories(history) -> dict:
    """All per-key subhistories in ONE pass over the parent history:
    ``{key: ops}`` with keys in first-seen order, values unwrapped and
    op indices preserved — equivalent to calling ``subhistory`` per key
    of ``history_keys`` but O(N) instead of O(K * N), which is what the
    batched checker axis needs (512 keys would otherwise re-scan the
    full history 512 times before any checking starts)."""
    out: dict = {}
    for op in history:
        v = op.get("value")
        if isinstance(v, tuple) and len(v) == 2:
            ops = out.get(v[0])
            if ops is None:
                ops = out[v[0]] = []
            ops.append(op.evolve(value=v[1]))
    return out
