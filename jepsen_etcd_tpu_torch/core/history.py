"""Histories: ordered op sequences (the subset the checker path uses).

A copy of ``History`` from the reference's ``core/history.py``:
construction (with index assignment), the sequence protocol and the
tagged JSONL round trip, and the filters the watch checker uses. The
reference's SoA ``OpColumns`` view and the pairing helpers come with
later slices.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterable, Iterator

from .op import Op


class History:
    """An immutable-by-convention sequence of ops."""

    def __init__(self, ops: Iterable[Op]):
        self._ops: list[Op] = [o if isinstance(o, Op) else Op(o)
                               for o in ops]
        # Assign indices to ops missing one, starting past any explicit
        # indices (so synthesized ops appended to a recorded history can't
        # collide); copy rather than mutate the caller's op.
        explicit = [o["index"] for o in self._ops
                    if o.get("index") is not None]
        if len(explicit) != len(set(explicit)):
            raise ValueError("duplicate op indices in history")
        nxt = max(explicit, default=-1) + 1
        for i, o in enumerate(self._ops):
            if o.get("index") is None:
                self._ops[i] = o.evolve(index=nxt)
                nxt += 1

    @property
    def ops(self) -> list[Op]:
        return self._ops

    # -- sequence protocol --------------------------------------------------
    def __len__(self) -> int:
        return len(self._ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self._ops)

    def __getitem__(self, i):
        return self._ops[i]

    # -- filters (jepsen.history-style) -------------------------------------
    def filter(self, pred: Callable[[Op], bool]) -> "History":
        return History([o for o in self._ops if pred(o)])

    def client_ops(self) -> "History":
        return self.filter(lambda o: isinstance(o.get("process"), int))

    def oks(self) -> "History":
        return self.filter(lambda o: o.get("type") == "ok")

    # -- (de)serialization ---------------------------------------------------
    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(_jsonable(o)) for o in self._ops)

    @classmethod
    def from_jsonl(cls, text: str) -> "History":
        ops = []
        for line in text.splitlines():
            line = line.strip()
            if line:
                ops.append(Op(_unjsonable(json.loads(line))))
        return cls(ops)

    def __repr__(self) -> str:
        return f"<History of {len(self)} ops>"


_SCALAR_TYPES = frozenset((str, int, float, bool, type(None)))


def _jsonable(x: Any) -> Any:
    """JSON encoding that round-trips tuples and sets (tagged).

    Op values use tuples structurally — e.g. the documented ``(key, value)``
    shape for independent workloads — so a plain list coercion would silently
    break tuple-equality in checkers over reloaded histories.
    """
    if isinstance(x, dict):
        if all(isinstance(k, str) for k in x) and not (
                set(x.keys()) & {"__tuple__", "__set__", "__dict__"}):
            return {k: _jsonable(v) for k, v in x.items()}
        # Non-string (or tag-colliding) keys: tagged pair-list encoding.
        return {"__dict__": [[_jsonable(k), _jsonable(v)]
                             for k, v in x.items()]}
    if isinstance(x, tuple):
        return {"__tuple__": [_jsonable(v) for v in x]}
    if isinstance(x, list):
        # a list of plain scalars is already JSON-clean
        if not set(map(type, x)) - _SCALAR_TYPES:
            return x
        return [_jsonable(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return {"__set__": sorted((_jsonable(v) for v in x), key=repr)}
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return repr(x)  # lossy fallback for exotic values; documented


def _hashable(x: Any) -> Any:
    """Make a decoded key usable as a dict key (lists -> tuples)."""
    if isinstance(x, list):
        return tuple(_hashable(v) for v in x)
    if isinstance(x, set):
        return frozenset(x)
    return x


def _unjsonable(x: Any) -> Any:
    if isinstance(x, dict):
        if set(x.keys()) == {"__tuple__"}:
            return tuple(_unjsonable(v) for v in x["__tuple__"])
        if set(x.keys()) == {"__set__"}:
            return set(_unjsonable(v) for v in x["__set__"])
        if set(x.keys()) == {"__dict__"}:
            return {_hashable(_unjsonable(k)): _unjsonable(v)
                    for k, v in x["__dict__"]}
        return {k: _unjsonable(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_unjsonable(v) for v in x]
    return x
