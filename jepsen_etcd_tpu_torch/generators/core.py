"""Pure, deterministic, seedable generator combinators.

Re-design of jepsen.generator as observed at the reference call sites
(SURVEY.md §2): ``mix``, ``reserve``, ``limit``, ``stagger``, ``phases``,
``time-limit``, ``nemesis``/``clients`` routing, ``each-thread``, ``sleep``,
``log`` (composition at ``etcd.clj:143-155``, ``register.clj:102-119``,
``set.clj:47``, ``watch.clj:359-379``, ``lock.clj:246,260``).

Protocol (mirrors jepsen.generator.Generator, single-op pipeline):

    gen.op(test, ctx)  -> None                      exhausted
                        | (PENDING, wake, gen')     nothing yet; wake is a
                                                    virtual time to re-poll
                                                    at, or None for "on next
                                                    event"
                        | (op_dict, gen')           op ready; op["time"] is
                                                    its earliest emission time
    gen.update(test, ctx, event) -> gen'            informed of invoke /
                                                    completion events

Generators are immutable: every state change returns a new instance, so the
interpreter can hold, replay, and route speculatively without aliasing bugs.
Every poll the interpreter makes is *committed* (it always adopts gen'),
which lets stateful combinators (stagger, sleep, time-limit, limit) keep
their bookkeeping in the returned copies.

Plain data lifts (ensure_gen):
  dict/Op      -> emit that op once
  callable     -> call f(test, ctx) (or f()) for a fresh op each emission;
                  exhausted when it returns None
  list/iter    -> each element is itself a generator, run in order
  None         -> exhausted
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Optional

from ..core.op import Op, NEMESIS

PENDING = "pending"
_arity_cache: dict = {}  # FnGen: f -> parameter count (inspect is hot-loop cost)


class _WorkersMap(dict):
    """Context.workers carrier with a memo of thread-subset dicts.

    The interpreter reuses one snapshot across polls until workers actually
    change, so restrict() (called per combinator level per poll — HOT LOOP
    #1, SURVEY §3.5) can reuse the subset dicts too.  Snapshots are replaced,
    never mutated, so sharing is safe.
    """

    __slots__ = ("sub_cache",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.sub_cache: dict = {}
SECOND = 1_000_000_000


# ---------------------------------------------------------------------------
# Context


class Context:
    """What a generator may observe: virtual time, free threads, workers.

    ``workers`` maps thread id -> current process (threads are stable; the
    process on a thread is bumped by `concurrency` when an op crashes with
    :info, cf. reference watch.clj:281-282).

    A plain __slots__ class, not a dataclass: the interpreter builds and
    restricts contexts several times per event (HOT LOOP #1), and frozen
    dataclass construction pays object.__setattr__ per field.  Restricted
    sub-contexts are memoized per instance — combinator walks restrict the
    same thread sets repeatedly at one instant.
    """

    __slots__ = ("time", "free", "workers", "rng", "concurrency",
                 "_sub", "_sorted_free")

    def __init__(self, time: int, free: frozenset, workers: dict,
                 rng: Any, concurrency: int):
        self.time = time
        self.free = free
        self.workers = workers
        self.rng = rng
        self.concurrency = concurrency
        self._sub: Optional[dict] = None
        self._sorted_free: Optional[list] = None

    def set_time(self, t: int) -> None:
        """Advance this context — and its memoized sub-contexts, which share
        the same clock — to virtual time t.  Lets the interpreter reuse one
        Context (and its restrict() memo) across polls while workers/free
        are unchanged and only time moves."""
        if self.time == t:
            return
        self.time = t
        if self._sub:
            for c in self._sub.values():
                c.set_time(t)

    def restrict(self, threads: frozenset) -> "Context":
        memo = self._sub
        if memo is None:
            memo = self._sub = {}
        else:
            got = memo.get(threads)
            if got is not None:
                return got
        w = self.workers
        cache = getattr(w, "sub_cache", None)
        sub = cache.get(threads) if cache is not None else None
        if sub is None:
            sub = _WorkersMap((t, p) for t, p in w.items() if t in threads)
            if cache is not None:
                cache[threads] = sub
        out = Context(time=self.time, free=self.free & threads,
                      workers=sub, rng=self.rng,
                      concurrency=self.concurrency)
        memo[threads] = out
        return out

    @property
    def client_threads(self) -> list:
        return sorted(t for t in self.workers if isinstance(t, int))

    @property
    def all_threads(self) -> frozenset:
        return frozenset(self.workers)

    @property
    def all_free(self) -> bool:
        return self.free == frozenset(self.workers)

    def some_free_process(self) -> Optional[Any]:
        """Pick a free process deterministically (seeded rng)."""
        cands = self._sorted_free
        if cands is None:
            cands = self._sorted_free = sorted(self.free, key=str)
        if not cands:
            return None
        t = self.rng.choice(cands)
        return self.workers[t]

    def thread_of(self, process: Any) -> Any:
        if not isinstance(process, int):
            return process  # "nemesis" etc.
        return process % self.concurrency


class Generator:
    """Base class; subclasses override op()/update()."""

    def op(self, test: Any, ctx: Context):
        raise NotImplementedError

    def update(self, test: Any, ctx: Context, event: Op) -> "Generator":
        return self


def ensure_gen(x: Any) -> Optional[Generator]:
    if x is None or isinstance(x, Generator):
        return x
    if isinstance(x, dict):
        return OnceOp(dict(x))
    if callable(x):
        return FnGen(x)
    if isinstance(x, (list, tuple)):
        return Seq(list(x), 0, None)
    if isinstance(x, Iterable):
        return Seq([], 0, iter(x))
    raise TypeError(f"cannot lift {x!r} to a generator")


def _fill_in(op_dict: dict, ctx: Context) -> Optional[Op]:
    """Assign process and earliest time to a raw op; None if no free thread."""
    op = Op(op_dict)
    if op.get("process") is None:
        p = ctx.some_free_process()
        if p is None:
            return None
        op["process"] = p
    if op.get("time") is None:
        op["time"] = ctx.time
    op.setdefault("type", "invoke")
    return op


# ---------------------------------------------------------------------------
# Leaves


@dataclass(frozen=True)
class OnceOp(Generator):
    """A plain map: emits exactly once."""

    proto: dict

    def op(self, test, ctx):
        op = _fill_in(self.proto, ctx)
        if op is None:
            return (PENDING, None, self)
        return (op, None_gen)


@dataclass(frozen=True)
class FnGen(Generator):
    """A function of (test, ctx) (or zero args): fresh op per emission.

    Mirrors jepsen fn-generators like register.clj:98-100 (`r`/`w`/`cas`).
    Exhausted when the function returns None.
    """

    f: Callable

    def _call(self, test, ctx):
        nparams = _arity_cache.get(self.f)
        if nparams is None:
            try:
                nparams = len(inspect.signature(self.f).parameters)
            except (TypeError, ValueError):
                nparams = 2
            _arity_cache[self.f] = nparams
        if nparams == 0:
            return self.f()
        if nparams == 1:
            return self.f(ctx)
        return self.f(test, ctx)

    def op(self, test, ctx):
        if not ctx.free:
            # Don't invoke f speculatively: a stateful source (e.g. popping
            # a finite list) would lose the produced op.
            return (PENDING, None, self)
        raw = self._call(test, ctx)
        if raw is None:
            return None
        op = _fill_in(raw, ctx)  # _fill_in copies via Op(raw)
        if op is None:
            return (PENDING, None, self)
        return (op, self)


@dataclass(frozen=True)
class Seq(Generator):
    """A sequence of sub-generators run in order; supports lazy iterables."""

    items: list  # materialized prefix (shared, append-only)
    idx: int
    it: Optional[Any]  # iterator for the lazy tail (shared)
    current: Optional[Generator] = None

    def _head(self):
        """Current sub-generator, materializing from the iterator on demand."""
        if self.current is not None:
            return self.current
        while self.idx >= len(self.items) and self.it is not None:
            try:
                self.items.append(next(self.it))
            except StopIteration:
                object.__setattr__(self, "it", None)
                break
        if self.idx < len(self.items):
            return ensure_gen(self.items[self.idx])
        return None

    def op(self, test, ctx):
        me = self
        while True:
            head = me._head()
            if head is None:
                return None
            res = head.op(test, ctx)
            if res is None:
                me = Seq(me.items, me.idx + 1, me.it, None)
                continue
            if res[0] == PENDING:
                _, wake, head2 = res
                if head2 is me.current:
                    return (PENDING, wake, me)
                return (PENDING, wake, Seq(me.items, me.idx, me.it, head2))
            op, head2 = res
            if head2 is me.current:
                return (op, me)
            return (op, Seq(me.items, me.idx, me.it, head2))

    def update(self, test, ctx, event):
        head = self._head()
        if head is None:
            return self
        h2 = head.update(test, ctx, event)
        if h2 is self.current:
            return self
        return Seq(self.items, self.idx, self.it, h2)


class _NoneGen(Generator):
    def op(self, test, ctx):
        return None


None_gen = _NoneGen()


# ---------------------------------------------------------------------------
# Combinators


@dataclass(frozen=True)
class Mix(Generator):
    """Random choice among sub-generators per emission (gen/mix)."""

    gens: tuple

    def op(self, test, ctx):
        alive = [(i, g) for i, g in enumerate(self.gens) if g is not None]
        if not alive:
            return None
        order = list(alive)
        ctx.rng.shuffle(order)
        pend_wake = "none"
        new = list(self.gens)
        changed = False
        for i, g in order:
            res = g.op(test, ctx)
            if res is None:
                new[i] = None
                changed = True
                continue
            if res[0] == PENDING:
                _, wake, g2 = res
                if g2 is not g:
                    new[i] = g2
                    changed = True
                pend_wake = _min_wake(pend_wake, wake)
                continue
            op, g2 = res
            if g2 is not g:
                new[i] = g2
                changed = True
            return (op, Mix(tuple(new)) if changed else self)
        if all(g is None for g in new):
            return None
        return (PENDING, None if pend_wake == "none" else pend_wake,
                Mix(tuple(new)) if changed else self)

    def update(self, test, ctx, event):
        new = tuple(g.update(test, ctx, event) if g else None
                    for g in self.gens)
        if all(a is b for a, b in zip(new, self.gens)):
            return self
        return Mix(new)


def _min_wake(a, b):
    if a == "none" or a is None:
        return b
    if b is None:
        return a
    return min(a, b)


@dataclass(frozen=True)
class Limit(Generator):
    """At most n ops (gen/limit), e.g. ops-per-key (register.clj:118)."""

    n: int
    gen: Optional[Generator]

    def op(self, test, ctx):
        if self.n <= 0 or self.gen is None:
            return None
        res = self.gen.op(test, ctx)
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            if g2 is self.gen:
                return (PENDING, wake, self)
            return (PENDING, wake, Limit(self.n, g2))
        op, g2 = res
        return (op, Limit(self.n - 1, g2))

    def update(self, test, ctx, event):
        if self.gen is None:
            return self
        g2 = self.gen.update(test, ctx, event)
        return self if g2 is self.gen else Limit(self.n, g2)


@dataclass(frozen=True)
class Stagger(Generator):
    """Space ops ~uniform[0, 2*dt] apart overall (gen/stagger).

    dt is the *mean* gap; aggregate rate across all threads is ~1/dt, the
    semantics the reference relies on for `--rate` (etcd.clj:145,190-193).
    """

    dt: int
    gen: Optional[Generator]
    next_time: Optional[int] = None

    def op(self, test, ctx):
        if self.gen is None:
            return None
        res = self.gen.op(test, ctx)
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            if g2 is self.gen:
                return (PENDING, wake, self)
            return (PENDING, wake, Stagger(self.dt, g2, self.next_time))
        op, g2 = res
        nt = self.next_time if self.next_time is not None else ctx.time
        t_emit = max(op["time"], nt)
        op["time"] = t_emit
        gap = int(ctx.rng.random() * 2 * self.dt)
        return (op, Stagger(self.dt, g2, t_emit + gap))

    def update(self, test, ctx, event):
        if self.gen is None:
            return self
        g2 = self.gen.update(test, ctx, event)
        return self if g2 is self.gen else Stagger(self.dt, g2,
                                                   self.next_time)


@dataclass(frozen=True)
class Delay(Generator):
    """Fixed dt between ops (gen/delay)."""

    dt: int
    gen: Optional[Generator]
    next_time: Optional[int] = None

    def op(self, test, ctx):
        if self.gen is None:
            return None
        res = self.gen.op(test, ctx)
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            if g2 is self.gen:
                return (PENDING, wake, self)
            return (PENDING, wake, Delay(self.dt, g2, self.next_time))
        op, g2 = res
        nt = self.next_time if self.next_time is not None else ctx.time
        t_emit = max(op["time"], nt)
        op["time"] = t_emit
        return (op, Delay(self.dt, g2, t_emit + self.dt))

    def update(self, test, ctx, event):
        if self.gen is None:
            return self
        g2 = self.gen.update(test, ctx, event)
        return self if g2 is self.gen else Delay(self.dt, g2,
                                                 self.next_time)


@dataclass(frozen=True)
class Sleep(Generator):
    """Emit nothing for dt, then exhaust (gen/sleep)."""

    dt: int
    deadline: Optional[int] = None

    def op(self, test, ctx):
        dl = self.deadline if self.deadline is not None else ctx.time + self.dt
        if ctx.time >= dl:
            return None
        if dl == self.deadline:
            return (PENDING, dl, self)
        return (PENDING, dl, Sleep(self.dt, dl))


@dataclass(frozen=True)
class TimeLimit(Generator):
    """Stop emitting t after the first poll (gen/time-limit)."""

    t: int
    gen: Optional[Generator]
    deadline: Optional[int] = None

    def op(self, test, ctx):
        dl = self.deadline if self.deadline is not None else ctx.time + self.t
        if ctx.time >= dl or self.gen is None:
            return None
        res = self.gen.op(test, ctx)
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            if g2 is self.gen and dl == self.deadline:
                return (PENDING, _min_wake(wake, dl), self)
            return (PENDING, _min_wake(wake, dl), TimeLimit(self.t, g2, dl))
        op, g2 = res
        if op["time"] >= dl:
            # Op would fire past the deadline: the limit cuts it off.
            return None
        if g2 is self.gen and dl == self.deadline:
            return (op, self)
        return (op, TimeLimit(self.t, g2, dl))

    def update(self, test, ctx, event):
        if self.gen is None:
            return self
        g2 = self.gen.update(test, ctx, event)
        return self if g2 is self.gen else TimeLimit(self.t, g2,
                                                     self.deadline)


@dataclass(frozen=True)
class Synchronize(Generator):
    """Wait until all workers are free before starting child (gen/synchronize)."""

    gen: Optional[Generator]
    started: bool = False

    def op(self, test, ctx):
        if self.gen is None:
            return None
        if not self.started and not ctx.all_free:
            return (PENDING, None, self)
        res = self.gen.op(test, ctx)
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            if g2 is self.gen and self.started:
                return (PENDING, wake, self)
            return (PENDING, wake, Synchronize(g2, True))
        op, g2 = res
        if g2 is self.gen and self.started:
            return (op, self)
        return (op, Synchronize(g2, True))

    def update(self, test, ctx, event):
        if self.gen is None:
            return self
        g2 = self.gen.update(test, ctx, event)
        return self if g2 is self.gen else Synchronize(g2, self.started)


@dataclass(frozen=True)
class Log(Generator):
    """Emit one no-thread log pseudo-op (gen/log); interpreter prints it."""

    msg: str

    def op(self, test, ctx):
        op = Op(type="log", f="log", value=self.msg, process="__log__",
                time=ctx.time)
        return (op, None_gen)


@dataclass(frozen=True)
class OnThreads(Generator):
    """Restrict a generator to a thread subset (gen/on-threads and friends)."""

    threads: frozenset
    gen: Optional[Generator]

    def op(self, test, ctx):
        if self.gen is None:
            return None
        res = self.gen.op(test, ctx.restrict(self.threads))
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            if g2 is self.gen:
                return (PENDING, wake, self)
            return (PENDING, wake, OnThreads(self.threads, g2))
        op, g2 = res
        if g2 is self.gen:
            return (op, self)
        return (op, OnThreads(self.threads, g2))

    def update(self, test, ctx, event):
        if self.gen is None:
            return self
        t = ctx.thread_of(event.get("process"))
        if t in self.threads:
            g2 = self.gen.update(test, ctx.restrict(self.threads), event)
            return self if g2 is self.gen else OnThreads(self.threads, g2)
        return self


@dataclass(frozen=True)
class Alt(Generator):
    """Poll several generators; emit the op with the soonest time.

    The combination engine behind reserve and nemesis/clients routing.
    Branches whose thread sets are disjoint run concurrently.
    """

    branches: tuple  # of OnThreads

    def op(self, test, ctx):
        best = None  # (op, idx, gen2)
        pend_wake = "none"
        any_alive = False
        new = list(self.branches)
        changed = False
        for i, b in enumerate(self.branches):
            res = b.op(test, ctx)
            if res is None:
                continue
            any_alive = True
            if res[0] == PENDING:
                _, wake, b2 = res
                if b2 is not b:
                    new[i] = b2
                    changed = True
                pend_wake = _min_wake(pend_wake, wake)
                continue
            op, b2 = res
            if best is None or op["time"] < best[0]["time"]:
                best = (op, i, b2)
        if best is not None:
            op, i, b2 = best
            if b2 is not new[i]:
                new[i] = b2
                changed = True
            return (op, Alt(tuple(new)) if changed else self)
        if not any_alive:
            return None
        return (PENDING, None if pend_wake == "none" else pend_wake,
                Alt(tuple(new)) if changed else self)

    def update(self, test, ctx, event):
        new = tuple(b.update(test, ctx, event) for b in self.branches)
        if all(a is b for a, b in zip(new, self.branches)):
            return self
        return Alt(new)


@dataclass(frozen=True)
class EachThread(Generator):
    """An independent copy of the generator per thread (gen/each-thread).

    Used for the watch workload's :final-watch (watch.clj:376-379).
    """

    spec: Any
    children: Any = None  # tuple of (thread, gen) once initialized
    done: frozenset = frozenset()

    def _init(self, ctx):
        if self.children is not None:
            return self
        ch = tuple((t, ensure_gen(self.spec)) for t in sorted(
            ctx.workers, key=str))
        return replace(self, children=ch)

    def op(self, test, ctx):
        me = self._init(ctx)
        best = None
        pend_wake = "none"
        alive = False
        new = list(me.children)
        changed = False
        for i, (t, g) in enumerate(me.children):
            if g is None:
                continue
            alive = True
            if t not in ctx.free:
                continue
            res = g.op(test, ctx.restrict(frozenset([t])))
            if res is None:
                new[i] = (t, None)
                changed = True
                continue
            if res[0] == PENDING:
                _, wake, g2 = res
                if g2 is not g:
                    new[i] = (t, g2)
                    changed = True
                pend_wake = _min_wake(pend_wake, wake)
                continue
            op, g2 = res
            if best is None or op["time"] < best[0]["time"]:
                best = (op, i, g2)
        if best is not None:
            op, i, g2 = best
            t = new[i][0]
            if g2 is not new[i][1]:
                new[i] = (t, g2)
                changed = True
            return (op, EachThread(me.spec, tuple(new), me.done)
                    if changed else me)
        if not any(g is not None for _, g in new):
            return None
        if not alive:
            return None
        return (PENDING, None if pend_wake == "none" else pend_wake,
                EachThread(me.spec, tuple(new), me.done) if changed else me)

    def update(self, test, ctx, event):
        if self.children is None:
            return self
        t_ev = ctx.thread_of(event.get("process"))
        new = tuple(
            (t, g.update(test, ctx.restrict(frozenset([t])), event)
             if (g is not None and t == t_ev) else g)
            for t, g in self.children)
        if all(a[1] is b[1] for a, b in zip(new, self.children)):
            return self
        return replace(self, children=new)


@dataclass(frozen=True)
class FMap(Generator):
    """Apply f to each emitted op (gen/map); used to wrap values."""

    f: Callable
    gen: Optional[Generator]

    def op(self, test, ctx):
        if self.gen is None:
            return None
        res = self.gen.op(test, ctx)
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            return (PENDING, wake,
                    self if g2 is self.gen else FMap(self.f, g2))
        op, g2 = res
        return (self.f(op), self if g2 is self.gen else FMap(self.f, g2))

    def update(self, test, ctx, event):
        if self.gen is None:
            return self
        g2 = self.gen.update(test, ctx, event)
        return self if g2 is self.gen else FMap(self.f, g2)


@dataclass(frozen=True)
class Cycle(Generator):
    """Restart the generator spec each time it exhausts (gen/cycle)."""

    spec: Any
    current: Optional[Generator] = None
    times: Optional[int] = None

    def op(self, test, ctx):
        me = self
        for _ in range(2):
            cur = me.current if me.current is not None else ensure_gen(me.spec)
            res = cur.op(test, ctx)
            if res is None:
                if me.times is not None and me.times <= 1:
                    return None
                nt = None if me.times is None else me.times - 1
                me = Cycle(me.spec, None, nt)
                continue
            if res[0] == PENDING:
                _, wake, g2 = res
                if g2 is me.current:
                    return (PENDING, wake, me)
                return (PENDING, wake, Cycle(me.spec, g2, me.times))
            op, g2 = res
            if g2 is me.current:
                return (op, me)
            return (op, Cycle(me.spec, g2, me.times))
        return (PENDING, None, me)

    def update(self, test, ctx, event):
        if self.current is None:
            return self
        g2 = self.current.update(test, ctx, event)
        return self if g2 is self.current else Cycle(self.spec, g2, self.times)


# ---------------------------------------------------------------------------
# Public constructors (jepsen.generator surface)


def once(x) -> Generator:
    return ensure_gen(dict(x) if isinstance(x, dict) else x)


def repeat(x, times: Optional[int] = None) -> Generator:
    return Cycle(x, None, times)


def cycle(x, times: Optional[int] = None) -> Generator:
    return Cycle(x, None, times)


def seq(*gens) -> Generator:
    return Seq(list(gens), 0, None)


def fn_gen(f) -> Generator:
    return FnGen(f)


def mix(gens: list) -> Generator:
    return Mix(tuple(ensure_gen(g) for g in gens))


def limit(n: int, gen) -> Generator:
    return Limit(n, ensure_gen(gen))


def stagger(dt: float, gen) -> Generator:
    return Stagger(int(dt), ensure_gen(gen))


def delay(dt: float, gen) -> Generator:
    return Delay(int(dt), ensure_gen(gen))


def sleep_gen(dt: float) -> Generator:
    return Sleep(int(dt))


def time_limit(t: float, gen) -> Generator:
    return TimeLimit(int(t), ensure_gen(gen))


def synchronize(gen) -> Generator:
    return Synchronize(ensure_gen(gen))


def phases(*gens) -> Generator:
    """Sequential phases, each starting only when all workers are free."""
    return Seq([Synchronize(ensure_gen(g)) for g in gens], 0, None)


def log(msg: str) -> Generator:
    return Log(msg)


def on_threads(threads, gen) -> Generator:
    return OnThreads(frozenset(threads), ensure_gen(gen))


def any_gen(*gens) -> Generator:
    return Alt(tuple(ensure_gen(g) for g in gens))


@dataclass(frozen=True)
class _ClientsOnly(Generator):
    """OnThreads over all integer threads, resolved lazily from ctx."""

    gen: Optional[Generator]

    def _restricted(self, ctx):
        return ctx.restrict(frozenset(t for t in ctx.workers
                                      if isinstance(t, int)))

    def op(self, test, ctx):
        if self.gen is None:
            return None
        res = self.gen.op(test, self._restricted(ctx))
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, g2 = res
            return (PENDING, wake,
                    self if g2 is self.gen else _ClientsOnly(g2))
        op, g2 = res
        return (op, self if g2 is self.gen else _ClientsOnly(g2))

    def update(self, test, ctx, event):
        if self.gen is None or not isinstance(event.get("process"), int):
            return self
        g2 = self.gen.update(test, self._restricted(ctx), event)
        return self if g2 is self.gen else _ClientsOnly(g2)


def clients(client_gen, nemesis_gen=None) -> Generator:
    """Route client_gen to client threads (gen/clients)."""
    branches = [_ClientsOnly(ensure_gen(client_gen))]
    if nemesis_gen is not None:
        branches.append(OnThreads(frozenset([NEMESIS]),
                                  ensure_gen(nemesis_gen)))
    return branches[0] if len(branches) == 1 else Alt(tuple(branches))


def nemesis(nemesis_gen, client_gen=None) -> Generator:
    """Route nemesis_gen to the nemesis thread; client_gen (if given) to
    clients — the 2-arity threading shape at etcd.clj:146-149."""
    branches = [OnThreads(frozenset([NEMESIS]), ensure_gen(nemesis_gen))]
    if client_gen is not None:
        branches.append(_ClientsOnly(ensure_gen(client_gen)))
    return branches[0] if len(branches) == 1 else Alt(tuple(branches))


@dataclass(frozen=True)
class Reserve(Generator):
    """Partition client threads into ranges, one generator per range
    (gen/reserve): reserve(n1, g1, n2, g2, ..., default).

    The first n1 client threads run g1, the next n2 run g2, ...; remaining
    threads run the default.  cf. register.clj:118, set.clj:47,
    watch.clj:374-377.
    """

    counts: tuple
    gens: tuple  # len(counts)+1, last is the default (may be None)
    resolved: Any = None  # tuple of OnThreads branches once ctx seen

    def _resolve(self, ctx):
        if self.resolved is not None:
            return self
        threads = sorted(t for t in ctx.workers if isinstance(t, int))
        if sum(self.counts) > len(threads):
            raise ValueError(
                f"reserve: {sum(self.counts)} reserved threads > "
                f"{len(threads)} client threads")
        branches = []
        at = 0
        for n, g in zip(self.counts, self.gens):
            branches.append(OnThreads(frozenset(threads[at:at + n]),
                                      ensure_gen(g)))
            at += n
        default = self.gens[len(self.counts)]
        if threads[at:]:  # an empty branch would pend forever
            branches.append(OnThreads(frozenset(threads[at:]),
                                      ensure_gen(default)))
        return replace(self, resolved=Alt(tuple(branches)))

    def op(self, test, ctx):
        me = self._resolve(ctx)
        res = me.resolved.op(test, ctx)
        if res is None:
            return None
        if res[0] == PENDING:
            _, wake, alt2 = res
            if alt2 is me.resolved:
                return (PENDING, wake, me)
            return (PENDING, wake, Reserve(me.counts, me.gens, alt2))
        op, alt2 = res
        if alt2 is me.resolved:
            return (op, me)
        return (op, Reserve(me.counts, me.gens, alt2))

    def update(self, test, ctx, event):
        me = self._resolve(ctx)
        alt2 = me.resolved.update(test, ctx, event)
        return me if alt2 is me.resolved else Reserve(me.counts, me.gens,
                                                      alt2)


def reserve(*args) -> Generator:
    """reserve(n1, g1, n2, g2, ..., default_gen)."""
    if len(args) % 2 != 1:
        raise ValueError("reserve takes pairs of (count, gen) plus a default")
    counts = tuple(args[0:-1:2])
    gens = tuple(list(args[1:-1:2]) + [args[-1]])
    return Reserve(counts, gens)


def each_thread(spec) -> Generator:
    return EachThread(spec)


def f_map(f, gen) -> Generator:
    return FMap(f, ensure_gen(gen))
