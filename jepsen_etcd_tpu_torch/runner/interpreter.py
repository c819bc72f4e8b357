"""The generator interpreter: schedules generator ops onto worker tasks.

The analog of jepsen.generator.interpreter (SURVEY §3.1 "HOT LOOP #1"),
re-designed for the virtual-time runtime.

Design (mirrors jepsen's): a coordinator coroutine polls the generator
(committed-poll protocol, see generators/core.py) and *immediately*
dispatches each op to its thread's worker inbox, marking the thread busy —
even ops whose :time is in the future (the worker sleeps until then). This
keeps a far-future op (e.g. a staggered nemesis op) from blocking other
threads' dispatch. Workers send invoke/completion events back on a single
queue; the coordinator records them in arrival (= virtual-time) order and
feeds them to generator.update.

Process semantics mirror jepsen: thread t starts as process t; when an op
completes as :info (indefinite — the worker may still hold resources), the
process is retired and replaced by process + concurrency, so thread =
process mod concurrency (cf. reference watch.clj:281-282).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..core.op import Op, NEMESIS, INFO
from ..core.history import History, ColumnsBuilder
from ..generators.core import Context, ensure_gen, PENDING, _WorkersMap
from .sim import Future, SimLoop, Queue, current_loop

import logging

logger = logging.getLogger("jepsen_etcd_tpu_torch.run")


async def interpret(
    test: Any,
    gen: Any,
    invoke: Callable,  # async (process, op) -> completed Op
    concurrency: int,
    nemesis_invoke: Optional[Callable] = None,  # async (op) -> completed Op
    loop: Optional[SimLoop] = None,
    on_op: Optional[Callable] = None,  # observer: called with each recorded op
    stream: Optional[Any] = None,  # runner.stream.StreamFeed (chunk drain)
) -> History:
    """Run a generator to exhaustion; returns the recorded history."""
    loop = loop or current_loop()
    gen = ensure_gen(gen)

    threads: list = list(range(concurrency)) + (
        [NEMESIS] if nemesis_invoke is not None else [])
    workers = {t: t for t in threads}
    free = set(threads)
    outstanding = {t: 0 for t in threads}  # dispatched, not yet completed
    inboxes = {t: Queue(loop) for t in threads}
    events: Queue = Queue(loop)  # ("invoke"|"complete", thread, op)
    history: list[Op] = []
    index = [0]
    # SoA columns emitted alongside the dict stream: one row per event,
    # so checkers can consume typed arrays with no per-op dict access
    # (core/history.py OpColumns; schema in OBSERVABILITY.md §columns)
    columns = ColumnsBuilder()
    col_append = columns.append
    # streaming check feed: the builder hands chunks to a checker
    # worker while generation proceeds (runner/stream.py)
    if stream is not None:
        stream.attach(columns)
    stream_tick = stream.on_record if stream is not None else None

    def record(op: Op) -> Op:
        op = Op(op)  # evolve() unrolled: one copy, two direct stores
        op["index"] = index[0]
        op["time"] = loop.now
        index[0] += 1
        history.append(op)
        col_append(op)
        if stream_tick is not None:
            stream_tick()
        if on_op is not None:
            on_op(op)
        return op

    # Snapshots shared across polls until the underlying sets mutate: ctx()
    # runs several times per op, and restrict() memoizes sub-contexts on the
    # Context instance (see generators.core.Context).  The Context itself is
    # cached too — across polls only virtual time moves, which set_time()
    # propagates in place — so the restrict() memo survives between polls.
    snap: dict = {"workers": None, "free": None, "ctx": None}

    def ctx() -> Context:
        c = snap["ctx"]
        if c is not None:
            c.set_time(loop.now)
            return c
        if snap["workers"] is None:
            snap["workers"] = _WorkersMap(workers)
        if snap["free"] is None:
            snap["free"] = frozenset(free)
        c = Context(time=loop.now, free=snap["free"],
                    workers=snap["workers"], rng=loop.rng,
                    concurrency=concurrency)
        snap["ctx"] = c
        return c

    async def worker(thread: Any) -> None:
        while True:
            op = await inboxes[thread].get()
            if op is None:
                return
            if op["time"] > loop.now:
                await loop.sleep(op["time"] - loop.now)
            p = workers[thread]
            if op.get("process") != p:
                op = op.evolve(process=p)
            events.put(("invoke", thread, op))
            try:
                if thread == NEMESIS:
                    done = await nemesis_invoke(op)
                else:
                    done = await invoke(workers[thread], op)
            except Exception as e:  # a worker crash is an indefinite op
                logger.exception("worker %r crashed on %r", thread, op)
                done = op.evolve(type=INFO, error=("worker-crash", repr(e)))
            done = Op(done)
            # Retire the process *here*, before we could dequeue a queued
            # next op: an :info process must never invoke again
            # (jepsen semantics; the coordinator may handle this event
            # only after we've already picked up the next op).
            if done.get("type") == INFO and isinstance(thread, int):
                workers[thread] = workers[thread] + concurrency
                snap["workers"] = None
                snap["ctx"] = None
            events.put(("complete", thread, done))

    tasks = [loop.spawn(worker(t), name=f"worker-{t}") for t in threads]

    def handle(kind: str, thread: Any, op: Op) -> None:
        nonlocal gen
        op = record(op)
        if kind == "complete":
            outstanding[thread] -= 1
            if outstanding[thread] == 0:
                free.add(thread)
                snap["free"] = None
                snap["ctx"] = None
        if gen is not None:
            gen = gen.update(test, ctx(), op)

    _DEADLINE = object()  # sentinel: next_event gave up waiting

    async def next_event(deadline: Optional[int] = None) -> None:
        """Handle one event; give up at deadline (virtual time) if given.

        The deadline path used to be ``wait_for(spawn(events.get()),
        dt)`` — a Task + coroutine + 2 Futures per poll, twice per op in
        rate-0 runs.  This open-codes the same dance with two plain
        bounce callbacks.  The bounces are not an accident: they
        reproduce the old shape's scheduler hops (task wakeup, then
        wait_for's on_done) so every externally visible callback keeps
        its exact (time, seq) order relative to worker puts — histories
        stay bit-identical to the task-based implementation.
        """
        if deadline is None:
            kind, thread, op = await events.get()
        else:
            if loop.now >= deadline:
                return
            f = loop.future()       # the queue getter (was: evget's)
            gate = loop.future()    # what we actually await
            got_item = False        # ~ "the evget task completed"

            def hop1(fut) -> None:  # ~ evget task wakeup + step
                nonlocal got_item
                got_item = True
                loop._push_soon(hop2, (fut,))

            def hop2(fut) -> None:  # ~ wait_for's on_done
                timer.cancel()
                if not gate._state:
                    gate.set_result(fut._result)

            def on_timeout() -> None:
                if not gate._state:
                    gate.set_result(_DEADLINE)

            if len(events):
                # unreachable in practice (the main loop drains the queue
                # synchronously before polling), kept for safety
                kind, thread, op = await events.get()
                handle(kind, thread, op)
                return
            events._getters.append(f)
            f.add_done_callback(hop1)
            timer = loop.call_at(deadline, on_timeout)
            got = await gate
            if got is _DEADLINE:
                if got_item:
                    # delivery raced the deadline and won (the old code's
                    # "task.done despite timeout" branch): handle it
                    kind, thread, op = f._result
                    handle(kind, thread, op)
                    return
                # ~ task.cancel(): the stale getter is cleaned up one
                # scheduler hop later, with Queue.get's re-route semantics
                # for an item delivered into the window
                def cleanup() -> None:
                    if f in events._getters:
                        events._getters.remove(f)
                    elif f._state == Future.DONE:
                        if events._getters:
                            events._getters.popleft().set_result(f._result)
                        else:
                            events._items.appendleft(f._result)

                loop._push_soon(cleanup, ())
                return
            kind, thread, op = got
        handle(kind, thread, op)

    while True:
        # Drain any already-queued events first so ctx is fresh.
        while len(events):
            kind, thread, op = await events.get()
            handle(kind, thread, op)
        res = gen.op(test, ctx()) if gen is not None else None
        if res is None:
            if len(free) == len(threads):
                break
            await next_event()
            continue
        if res[0] == PENDING:
            _, wake, gen = res
            if wake is not None and wake > loop.now:
                await next_event(deadline=wake)
            else:
                await next_event()
            continue
        op, gen = res
        if op.get("type") == "log":
            logger.info("%s", op.get("value"))
            continue
        thread = op["process"] if not isinstance(op["process"], int) \
            else op["process"] % concurrency
        # The generator state for this op is already committed, so the op
        # must not be dropped: enqueue even onto a busy thread (the worker
        # drains its inbox sequentially); `free` stays false until the
        # inbox is empty again (see handle()).
        if thread in free:
            free.discard(thread)
            snap["free"] = None
            snap["ctx"] = None
        outstanding[thread] += 1
        inboxes[thread].put(op)

    for t in threads:
        inboxes[t].put(None)  # retire workers
    for t in tasks:
        await t
    return History(history, columns=columns.finish())
