"""Key-level data parallelism: jepsen.independent re-designed.

``concurrent_generator(n, keys, gen_fn)`` partitions client threads into
groups of ``n``; each group works through keys from a shared (possibly
infinite) key sequence, running ``gen_fn(key)`` with op values wrapped as
``(key, v)`` tuples.  This is the main data-parallel axis of the framework:
the matching ``independent`` *checker* (checkers/independent.py) splits the
history back per key — and on TPU, vmaps the per-key linearizability search
over the key batch.

Reference: register workload composition at ``register.clj:113-119``
(``independent/concurrent-generator (* 2 n) (range) (fn [k] ...)``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Iterable, Optional

from ..core.op import Op
from .core import (
    Generator, Context, PENDING, ensure_gen, _min_wake,
)

EXHAUSTED = object()


class KeySeq:
    """Append-only memo over a (possibly infinite) key iterable: shared,
    deterministic, safe for the committed-poll protocol."""

    def __init__(self, keys: Iterable):
        self._memo: list = []
        self._it = iter(keys)

    def get(self, i: int):
        while i >= len(self._memo) and self._it is not None:
            try:
                self._memo.append(next(self._it))
            except StopIteration:
                self._it = None
        return self._memo[i] if i < len(self._memo) else EXHAUSTED


def tuple_value(k: Any, v: Any) -> tuple:
    return (k, v)


def untuple(op: Op) -> Op:
    """Strip the (key, v) wrapper from an op's value."""
    v = op.get("value")
    if isinstance(v, tuple) and len(v) == 2:
        return op.evolve(value=v[1])
    return op


@dataclass(frozen=True)
class ConcurrentGenerator(Generator):
    """Thread groups of size n, each processing keys independently."""

    n: int
    keys: KeySeq
    gen_fn: Callable
    # (threads_frozenset, key_or_None, gen_or_None) per group, once resolved
    groups: Optional[tuple] = None
    next_key: int = 0

    def _resolve(self, ctx: Context) -> "ConcurrentGenerator":
        if self.groups is not None:
            return self
        threads = sorted(t for t in ctx.workers if isinstance(t, int))
        gs = []
        for at in range(0, len(threads) - self.n + 1, self.n):
            gs.append((frozenset(threads[at:at + self.n]), None, None))
        if not gs:
            raise ValueError(
                f"concurrent_generator: {len(threads)} client threads is "
                f"fewer than group size {self.n}")
        return replace(self, groups=tuple(gs))

    def op(self, test, ctx):
        me = self._resolve(ctx)
        # One mutable copy of the group table per poll; a new generator
        # instance is built at most once, and only when something moved.
        gs = list(me.groups)
        next_key = me.next_key
        changed = False
        best = None  # (op, i, key, gen2, threads)
        pend_wake = "none"
        for i in range(len(gs)):
            threads, key, g = gs[i]
            if g is None:
                k = me.keys.get(next_key)
                if k is EXHAUSTED:
                    continue  # keys exhausted; group retires
                next_key += 1
                key, g = k, ensure_gen(me.gen_fn(k))
                gs[i] = (threads, key, g)
                changed = True
            sub = ctx.restrict(threads)
            # A group may need several polls if its gen exhausts: move to
            # the next key immediately.
            while True:
                res = g.op(test, sub)
                if res is None:
                    k = me.keys.get(next_key)
                    if k is EXHAUSTED:
                        g = None
                        break
                    next_key += 1
                    key, g = k, ensure_gen(me.gen_fn(k))
                    gs[i] = (threads, key, g)
                    changed = True
                    continue
                break
            if g is None:
                gs[i] = (threads, None, None)
                changed = True
                continue
            if res[0] == PENDING:
                _, wake, g2 = res
                pend_wake = _min_wake(pend_wake, wake)
                if g2 is not g:
                    gs[i] = (threads, key, g2)
                    changed = True
                continue
            op, g2 = res
            if best is None or op["time"] < best[0]["time"]:
                best = (op, i, key, g2, threads)
        if best is not None:
            op, i, key, g2, threads = best
            if g2 is not gs[i][2]:
                gs[i] = (threads, key, g2)
                changed = True
            if changed:
                me = ConcurrentGenerator(me.n, me.keys, me.gen_fn,
                                         tuple(gs), next_key)
            wrapped = op.evolve(value=(key, op.get("value")))
            return (wrapped, me)
        alive = any(g is not None for _, _, g in gs) \
            or me.keys.get(next_key) is not EXHAUSTED
        if not alive:
            return None
        if changed:
            me = ConcurrentGenerator(me.n, me.keys, me.gen_fn,
                                     tuple(gs), next_key)
        return (PENDING, None if pend_wake == "none" else pend_wake, me)

    def update(self, test, ctx, event):
        if self.groups is None:
            return self
        p = event.get("process")
        if not isinstance(p, int):
            return self
        t = ctx.thread_of(p)
        for i, (threads, key, g) in enumerate(self.groups):
            if g is not None and t in threads:
                g2 = g.update(test, ctx.restrict(threads), untuple(event))
                if g2 is g:
                    return self
                gs = list(self.groups)
                gs[i] = (threads, key, g2)
                return ConcurrentGenerator(self.n, self.keys, self.gen_fn,
                                           tuple(gs), self.next_key)
        return self


def concurrent_generator(n: int, keys: Iterable, gen_fn: Callable) -> Generator:
    return ConcurrentGenerator(n, KeySeq(keys), gen_fn)


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
