"""Constructors for the little transaction AST.

Mirrors the reference txn language (``client/txn.clj``): ops are
``("get", k)`` / ``("put", k, v)``; comparison targets are
``("version", v)``, ``("value", v)``, ``("mod-revision", r)``,
``("create-revision", r)``; comparisons are ``("=", k, target)``,
``("<", k, target)``, (">", k, target)``.

Workloads build guards exactly like the reference does, e.g. the append
workload's optimistic-txn guards (append.clj:85-97):

    eq(k, mod_revision(rev))     # key unchanged since read
    lt(k, mod_revision(rev + 1)) # key still absent (mod-rev 0 < read rev+1)
"""

from __future__ import annotations

from typing import Any


def get(k: str) -> tuple:
    return ("get", k)


def put(k: str, v: Any) -> tuple:
    return ("put", k, v)


def delete(k: str) -> tuple:
    return ("delete", k)


def version(v: int) -> tuple:
    return ("version", v)


def value(v: Any) -> tuple:
    return ("value", v)


def mod_revision(r: int) -> tuple:
    return ("mod-revision", r)


def create_revision(r: int) -> tuple:
    return ("create-revision", r)


def eq(k: str, target: tuple) -> tuple:
    return ("=", k, target)


def lt(k: str, target: tuple) -> tuple:
    return ("<", k, target)


def gt(k: str, target: tuple) -> tuple:
    return (">", k, target)
