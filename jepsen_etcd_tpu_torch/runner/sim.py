"""A tiny deterministic virtual-time coroutine kernel.

The reference harness runs real JVM threads against a real cluster over
wall-clock time.  Our hermetic design replaces that with *virtual time*: all
concurrency (worker threads, nemesis, watch streams, lease expiry, raft
election timers) runs on this single-threaded, discrete-event scheduler.  A
10k-op history at 200 Hz spans 50 virtual seconds but executes in
milliseconds, and every run is exactly reproducible from its seed —
a capability the reference lacks (its histories are wall-clock
nondeterministic).

This is intentionally *not* asyncio: the scheduler must be deterministic
(heap ordered by (time, seq)), the clock must be virtual, and we need
precise control of cancellation for op timeouts (cf. reference
``client.clj:244-252`` — await with 5 s timeout -> indefinite result).

Generator-epoch ledger
----------------------
The same-instant ordering rule IS the determinism contract: the golden
hashes pin histories, and the hashes are only stable because the rule
below never changes silently. Changing how ties break — or anything
else that re-keys a same-seed history — requires declaring a NEW epoch
here, not editing an old one.

- **epoch-v1** (this module, SimLoop): events order by ``(time, seq)``
  — same-instant events run in push order, i.e. the order coroutines
  happened to schedule them. Same-seed runs give byte-equal
  histories (``History.to_jsonl``).
- **epoch-v2** (``simbatch/``, the lockstep batched generator): events
  order by ``(time, lane, seq)`` — same-instant events drain in
  ascending owning-lane order, push order only as the final tiebreak.
  A 16-seed golden-hash pin freezes epoch-v2 histories
  (histories differ op-by-op across epochs — that is the point of
  declaring an epoch — but checker verdicts must not).
- **epoch-v3** (``simbatch/engine_v3.py``, the device generator):
  same ``(time, lane, seq)`` ordering rule as epoch-v2 — lane-residue
  times keep per-seed event times unique, so the heap's pop sequence
  materializes as one argsort and the register machine runs as one
  drain kernel launch on the card. Random blocks come from a bit-exact
  threefry-2x32 (``simbatch/threefry.py``) under a per-seed key
  ``(0, seed mod 2**32)`` with a fixed 12-way subkey split, so
  histories differ from epoch-v2 draw-by-draw; the MVCC workloads
  delegate to the epoch-v2 per-seed sweep and are bit-identical to it.

Runs record their generator epoch (``gen_epoch`` in test.json), so
stored histories always re-check against the rule that produced them.

Coroutines are plain ``async def`` functions awaiting our ``Future``s.
"""

from __future__ import annotations

import heapq
import itertools
import random
from collections import deque
from typing import Any, Awaitable, Callable, Coroutine, Generator, Optional

SECOND = 1_000_000_000  # virtual nanoseconds


class Cancelled(BaseException):
    """Raised inside a coroutine when its task is cancelled (op timeout)."""


class Future:
    """A one-shot value container awaitable from coroutines."""

    __slots__ = ("loop", "_state", "_result", "_callbacks")

    PENDING, DONE, ERROR = 0, 1, 2

    def __init__(self, loop: "SimLoop"):
        self.loop = loop
        self._state = Future.PENDING
        self._result: Any = None
        # lazily allocated: most futures (sleeps, queue getters) collect
        # exactly one callback, many collect none before resolution
        self._callbacks: Optional[list] = None

    @property
    def done(self) -> bool:
        return self._state != Future.PENDING

    def set_result(self, value: Any) -> None:
        if self._state:
            return
        self._state = Future.DONE
        self._result = value
        if self._callbacks:
            self._fire()

    def set_exception(self, exc: BaseException) -> None:
        if self._state:
            return
        self._state = Future.ERROR
        self._result = exc
        if self._callbacks:
            self._fire()

    def result(self) -> Any:
        if self._state == Future.DONE:
            return self._result
        if self._state == Future.ERROR:
            raise self._result
        raise RuntimeError("future not done")

    def add_done_callback(self, cb: Callable[["Future"], None]) -> None:
        if self._state:
            self.loop._push_soon(cb, (self,))
        elif self._callbacks is None:
            self._callbacks = [cb]
        else:
            self._callbacks.append(cb)

    def _fire(self) -> None:
        cbs, self._callbacks = self._callbacks, None
        push = self.loop._push_soon
        for cb in cbs:
            push(cb, (self,))

    def __await__(self) -> Generator["Future", None, Any]:
        if not self._state:
            yield self
        return self.result()


class Task(Future):
    """A running coroutine; itself awaitable for the coroutine's result."""

    __slots__ = ("coro", "name", "_waiting_on", "_cancel_requested")

    def __init__(self, loop: "SimLoop", coro: Coroutine, name: str = "task"):
        super().__init__(loop)
        self.coro = coro
        self.name = name
        self._waiting_on: Optional[Future] = None
        self._cancel_requested = False
        loop._push_soon(self._step, (None, None))

    def cancel(self, exc: BaseException | None = None) -> None:
        """Throw Cancelled into the coroutine at its next suspension point."""
        if self._state:
            return
        self._cancel_requested = True
        # Detach from whatever we were awaiting (its wakeup becomes stale)
        # and resume with the cancellation.
        self._waiting_on = None
        self.loop._push_soon(self._step, (None, exc or Cancelled()))

    def _wakeup(self, fut: Future) -> None:
        if self._state or self._waiting_on is not fut:
            return  # stale wakeup (e.g. cancelled meanwhile)
        self._waiting_on = None
        if fut._state == Future.ERROR:
            self._step(None, fut._result)
        else:
            self._step(fut._result, None)

    def _step(self, value: Any, exc: BaseException | None) -> None:
        if self._state:
            return
        if self._cancel_requested and exc is None:
            exc = Cancelled()
        self._cancel_requested = False
        self.loop._current_task = self
        try:
            if exc is not None:
                fut = self.coro.throw(exc)
            else:
                fut = self.coro.send(value)
        except StopIteration as e:
            self.set_result(e.value)
            return
        except Cancelled as e:
            self.set_exception(e)
            return
        except BaseException as e:
            self.set_exception(e)
            return
        finally:
            self.loop._current_task = None
        if not isinstance(fut, Future):
            raise TypeError(f"task {self.name} awaited non-Future {fut!r}")
        self._waiting_on = fut
        fut.add_done_callback(self._wakeup)


class Timer:
    """Handle for a scheduled callback; cancel() makes it a silent no-op.

    Cancellation leaves a tombstone entry in the owning loop's heap; the
    loop counts them and compacts the heap once tombstones dominate (a
    cancel-heavy nemesis schedule would otherwise grow the heap without
    bound, and every push would pay log(dead + live)).
    """

    __slots__ = ("_entry", "_loop")

    def __init__(self, entry: list, loop: "SimLoop"):
        self._entry = entry
        self._loop = loop

    def cancel(self) -> None:
        entry = self._entry
        if entry[2] is not None:
            entry[2] = None
            loop = self._loop
            loop._dead += 1
            if loop._dead > loop.COMPACT_FLOOR and \
                    loop._dead * 2 > len(loop._heap):
                loop._compact()

    @property
    def cancelled(self) -> bool:
        return self._entry[2] is None


class SimLoop:
    """Deterministic discrete-event scheduler with a virtual clock."""

    #: minimum tombstone count before heap compaction kicks in — below
    #: this, a filter + heapify costs more than just popping the dead
    COMPACT_FLOOR = 64

    def __init__(self, seed: int = 0):
        self.now: int = 0  # virtual ns
        self.rng = random.Random(seed)
        self._heap: list[list] = []  # [time, seq, cb_or_None, args]
        self._seq = itertools.count()
        self._current_task: Optional[Task] = None
        self._dead = 0  # cancelled entries still in the heap
        self.tasks: list[Task] = []

    # -- scheduling ---------------------------------------------------------
    def _push_soon(self, cb: Callable, args: tuple) -> None:
        """Hot-path call_soon: no Timer handle, no clamping."""
        heapq.heappush(self._heap, [self.now, next(self._seq), cb, args])

    def _push_at(self, t: int, cb: Callable, args: tuple) -> None:
        """Hot-path call_at: no Timer handle."""
        if t < self.now:
            t = self.now
        heapq.heappush(self._heap, [t, next(self._seq), cb, args])

    def call_at(self, t: int, cb: Callable, *args: Any) -> Timer:
        entry = [max(int(t), self.now), next(self._seq), cb, args]
        heapq.heappush(self._heap, entry)
        return Timer(entry, self)

    def call_later(self, dt: int, cb: Callable, *args: Any) -> Timer:
        return self.call_at(self.now + int(dt), cb, *args)

    def call_soon(self, cb: Callable, *args: Any) -> Timer:
        return self.call_at(self.now, cb, *args)

    def spawn(self, coro: Coroutine, name: str = "task") -> Task:
        t = Task(self, coro, name)
        self.tasks.append(t)
        return t

    # -- primitives ---------------------------------------------------------
    def sleep(self, dt: float) -> Future:
        """Await to pause for dt virtual ns."""
        f = Future(self)
        self._push_at(self.now + int(dt), f.set_result, (None,))
        return f

    def future(self) -> Future:
        return Future(self)

    def _compact(self) -> None:
        """Drop tombstoned entries and restore the heap invariant.

        heapify preserves the total (time, seq) order of live entries, so
        compaction can never reorder callbacks.
        """
        heap = self._heap
        heap[:] = [e for e in heap if e[2] is not None]
        heapq.heapify(heap)
        self._dead = 0

    # -- running ------------------------------------------------------------
    def run(self, until: Optional[Future] = None, max_time: Optional[int] = None) -> Any:
        """Run until `until` completes (or the heap drains)."""
        heap = self._heap
        pop = heapq.heappop
        while heap:
            head = heap[0]
            if head[2] is None:  # cancelled timer: drop silently,
                pop(heap)        # without advancing the clock
                self._dead -= 1
                continue
            t = head[0]
            if until is not None and until._state and t > self.now:
                # Drain same-instant callbacks (e.g. cancellations issued in
                # the completing step) before stopping.
                break
            if max_time is not None and t > max_time:
                self.now = max_time
                break  # event stays queued for a later run()
            self.now = t
            # batch: every entry sharing this timestamp drains in one
            # pass, in (time, seq) pop order — entries a callback pushes
            # at the same instant join the batch, exactly as before
            while heap and heap[0][0] == t:
                entry = pop(heap)
                cb = entry[2]
                if cb is None:
                    self._dead -= 1
                    continue
                cb(*entry[3])
        if until is not None:
            if not until.done:
                raise RuntimeError(
                    f"loop drained at t={self.now} with awaited future pending"
                )
            return until.result()
        return None

    def run_coro(self, coro: Coroutine, name: str = "main") -> Any:
        return self.run(until=self.spawn(coro, name))


# -- structured concurrency helpers (awaitables) ----------------------------

_ACTIVE_LOOP: Optional[SimLoop] = None


def set_current_loop(loop: Optional[SimLoop]) -> None:
    global _ACTIVE_LOOP
    _ACTIVE_LOOP = loop


def current_loop() -> SimLoop:
    if _ACTIVE_LOOP is None:
        raise RuntimeError("no active SimLoop (use set_current_loop)")
    return _ACTIVE_LOOP


async def sleep(dt: float) -> None:
    await current_loop().sleep(dt)


async def wait_for(task: "Task | Future", timeout: float) -> Any:
    """Await a future with a virtual-time timeout.

    On timeout, cancels the task (if cancellable) and raises TimeoutError —
    the analog of the reference's deref-with-timeout (``client.clj:244-252``).
    """
    loop = current_loop()
    gate = Future(loop)

    def on_timeout() -> None:
        if not gate.done:
            gate.set_result("__timeout__")

    timer = loop.call_later(int(timeout), on_timeout)

    def on_done(f: Future) -> None:
        timer.cancel()
        if not gate.done:
            gate.set_result(f)

    task.add_done_callback(on_done)
    first = await gate
    if first == "__timeout__" and not task.done:
        if isinstance(task, Task):
            task.cancel()
        raise TimeoutError(f"timed out after {timeout} ns")
    return task.result()


class Event:
    """Level-triggered event: await until set."""

    def __init__(self, loop: Optional[SimLoop] = None):
        self.loop = loop or current_loop()
        self._set = False
        self._waiters: list[Future] = []

    @property
    def is_set(self) -> bool:
        return self._set

    def set(self) -> None:
        self._set = True
        ws, self._waiters = self._waiters, []
        for w in ws:
            w.set_result(None)

    def clear(self) -> None:
        self._set = False

    async def wait(self) -> None:
        if self._set:
            return
        f = Future(self.loop)
        self._waiters.append(f)
        await f


class Queue:
    """Unbounded FIFO queue."""

    def __init__(self, loop: Optional[SimLoop] = None):
        self.loop = loop or current_loop()
        self._items: deque = deque()
        self._getters: deque[Future] = deque()

    def put(self, item: Any) -> None:
        if self._getters:
            self._getters.popleft().set_result(item)
        else:
            self._items.append(item)

    async def get(self) -> Any:
        if self._items:
            return self._items.popleft()
        f = Future(self.loop)
        self._getters.append(f)
        try:
            return await f
        except BaseException:
            # Cancelled while waiting: withdraw, or re-route an item that
            # was delivered to us but never consumed — to the next waiting
            # getter if any (they won't be woken by a future put), else
            # back to the head of the queue.
            if f in self._getters:
                self._getters.remove(f)
            elif f._state == Future.DONE:
                if self._getters:
                    self._getters.popleft().set_result(f._result)
                else:
                    self._items.appendleft(f._result)
            raise

    def __len__(self) -> int:
        return len(self._items)


async def gather(*aws: Future) -> list:
    """Await all; raises the first child exception after all settle.

    A Cancelled thrown into the *gathering* task itself propagates
    immediately — op-timeout cancellation must terminate the caller.
    """
    results = []
    first_exc: BaseException | None = None
    for a in aws:
        try:
            results.append(await a)
        except Cancelled:
            if a.done and a._state == Future.ERROR:
                # the settled child's own cancellation surfaced via result()
                if first_exc is None:
                    first_exc = a._result
                results.append(None)
            else:
                raise  # thrown into *us* (even if the child happened to
                       # succeed in the same instant)
        except BaseException as e:  # noqa: BLE001 - propagate after settling
            if first_exc is None:
                first_exc = e
            results.append(None)
    if first_exc is not None:
        raise first_exc
    return results
