"""The operation model.

Jepsen represents operations as Clojure maps with keys ``:type`` (one of
``:invoke``, ``:ok``, ``:fail``, ``:info``), ``:f``, ``:value``, ``:process``,
``:time`` (nanoseconds), ``:index``, plus ad-hoc extras (``:error``,
``:debug``, ...).  Checkers nil-pun missing keys heavily, so we model an op as
a thin ``dict`` subclass with attribute access that returns ``None`` for
missing keys.

Reference semantics: jepsen.etcd records histories through jepsen's generator
interpreter; op shape is visible throughout the reference, e.g.
``register.clj:98-100`` (op constructors ``r``/``w``/``cas``) and
``watch.clj:278-291`` (thread recovery via ``(mod process concurrency)``).
"""

from __future__ import annotations

from typing import Any, Iterable

#: the distinguished nemesis "process"; jepsen uses the keyword :nemesis.
NEMESIS = "nemesis"

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

COMPLETIONS = (OK, FAIL, INFO)


class Op(dict):
    """An operation: a dict with attribute access (missing keys -> None).

    ``op.type`` is one of "invoke", "ok", "fail", "info".
    ``op.f`` is the function tag (e.g. "read", "write", "cas", "txn").
    ``op.value`` is workload-specific; for independent (per-key) workloads it
    is a ``(key, value)`` tuple, mirroring jepsen.independent.
    ``op.process`` is an int worker process, or "nemesis".
    ``op.time`` is virtual nanoseconds since test start.
    ``op.index`` is the global history index (dense, 0-based).
    """

    __slots__ = ()

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        return self.get(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # -- predicates ---------------------------------------------------------
    @property
    def is_invoke(self) -> bool:
        return self.get("type") == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.get("type") == OK

    @property
    def is_fail(self) -> bool:
        return self.get("type") == FAIL

    @property
    def is_info(self) -> bool:
        return self.get("type") == INFO

    @property
    def is_completion(self) -> bool:
        return self.get("type") in COMPLETIONS

    @property
    def is_client_op(self) -> bool:
        return isinstance(self.get("process"), int)

    def evolve(self, **kw: Any) -> "Op":
        """Copy with updates (the op analog of clojure's assoc)."""
        new = Op(self)
        new.update(kw)
        return new

    def __repr__(self) -> str:  # compact, jepsen-log-like
        base = f"{self.get('index')}\t{self.get('process')}\t{self.get('type')}\t{self.get('f')}\t{self.get('value')!r}"
        err = self.get("error")
        return base + (f"\t{err!r}" if err is not None else "")


def invoke_op(process: Any, f: str, value: Any = None, **extra: Any) -> Op:
    op = Op(type=INVOKE, f=f, value=value, process=process)
    op.update(extra)
    return op


def _complete(op: Op, type_: str, **extra: Any) -> Op:
    new = op.evolve(type=type_)
    new.update(extra)
    return new


def ok(op: Op, **extra: Any) -> Op:
    return _complete(op, OK, **extra)


def fail(op: Op, error: Any = None, **extra: Any) -> Op:
    return _complete(op, FAIL, error=error, **extra)


def info(op: Op, error: Any = None, **extra: Any) -> Op:
    return _complete(op, INFO, error=error, **extra)


def ops_by_f(ops: Iterable[Op], f: str) -> list[Op]:
    return [o for o in ops if o.get("f") == f]
