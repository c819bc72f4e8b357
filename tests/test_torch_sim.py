"""Twin of the reference's ``tests/test_sim.py`` on the port's
``runner/sim.py`` (the virtual-time loop; it differs from the
reference's in its docstring only). Each test runs on both packages
(``both``), each on a fresh ``SimLoop`` as the reference's fixture
makes it, and what it observes (traces, virtual times, heap sizes) is
equal."""

import pytest

from test_torch_fixtures import both, mod, one_torch_thread  # noqa: F401


def on_loop(body, seed=42):
    """``body(sim, loop)`` on both packages, each on its own current
    loop; returns the port's output, equal to the reference's."""
    def run(pkg):
        sim = mod(pkg, "runner.sim")
        loop = sim.SimLoop(seed=seed)
        sim.set_current_loop(loop)
        try:
            return body(sim, loop)
        finally:
            sim.set_current_loop(None)
    return both(run)


def _virtual_time_sleep(sim, loop):
    trace = []

    async def worker(name, dt):
        await sim.sleep(dt)
        trace.append((name, loop.now))

    async def main():
        a = loop.spawn(worker("a", 3 * sim.SECOND))
        b = loop.spawn(worker("b", 1 * sim.SECOND))
        await sim.gather(a, b)

    loop.run_coro(main())
    assert trace == [("b", 1 * sim.SECOND), ("a", 3 * sim.SECOND)]
    assert loop.now == 3 * sim.SECOND
    return trace


def test_virtual_time_sleep():
    on_loop(_virtual_time_sleep)


def _determinism(pkg):
    sim = mod(pkg, "runner.sim")

    def run_once():
        loop = sim.SimLoop(seed=7)
        sim.set_current_loop(loop)
        trace = []

        async def w(i):
            await sim.sleep(loop.rng.randint(0, sim.SECOND))
            trace.append((i, loop.now))

        async def main():
            await sim.gather(*[loop.spawn(w(i)) for i in range(10)])

        loop.run_coro(main())
        sim.set_current_loop(None)
        return trace

    first = run_once()
    assert first == run_once()
    return first


def test_determinism():
    both(_determinism)


def _wait_for_timeout(sim, loop):
    cancelled = []

    async def slow():
        try:
            await sim.sleep(10 * sim.SECOND)
        except sim.Cancelled:
            cancelled.append(loop.now)
            raise

    async def main():
        t = loop.spawn(slow())
        with pytest.raises(TimeoutError):
            await sim.wait_for(t, 2 * sim.SECOND)

    loop.run_coro(main())
    assert cancelled == [2 * sim.SECOND]
    assert loop.now == 2 * sim.SECOND
    return cancelled


def test_wait_for_timeout():
    on_loop(_wait_for_timeout)


def _wait_for_success(sim, loop):
    async def quick():
        await sim.sleep(sim.SECOND)
        return "done"

    async def main():
        return await sim.wait_for(loop.spawn(quick()), 5 * sim.SECOND)

    out = loop.run_coro(main())
    assert out == "done"
    return out, loop.now


def test_wait_for_success():
    on_loop(_wait_for_success)


def _event(sim, loop):
    order = []
    ev = None

    async def waiter(i):
        await ev.wait()
        order.append(i)

    async def setter():
        await sim.sleep(sim.SECOND)
        ev.set()

    async def main():
        ts = [loop.spawn(waiter(i)) for i in range(3)]
        loop.spawn(setter())
        await sim.gather(*ts)

    async def top():
        nonlocal ev
        ev = sim.Event(loop)
        await main()

    loop.run_coro(top())
    assert order == [0, 1, 2]
    return order, loop.now


def test_event():
    on_loop(_event)


def _queue(sim, loop):
    got = []

    async def consumer(q):
        for _ in range(3):
            got.append(await q.get())

    async def main():
        q = sim.Queue(loop)
        c = loop.spawn(consumer(q))
        q.put(1)
        await sim.sleep(sim.SECOND)
        q.put(2)
        q.put(3)
        await c

    loop.run_coro(main())
    assert got == [1, 2, 3]
    return got, loop.now


def test_queue():
    on_loop(_queue)


def _exception_propagates(sim, loop):
    async def boom():
        await sim.sleep(1)
        raise ValueError("boom")

    async def main():
        await loop.spawn(boom())

    with pytest.raises(ValueError) as e:
        loop.run_coro(main())
    return str(e.value), loop.now


def test_exception_propagates():
    on_loop(_exception_propagates)


def _max_time_resumable(sim, loop):
    ticks = []

    async def ticker():
        for _ in range(4):
            await sim.sleep(2 * sim.SECOND)
            ticks.append(loop.now)

    t = loop.spawn(ticker())
    loop.run(max_time=3 * sim.SECOND)
    assert ticks == [2 * sim.SECOND]
    loop.run(until=t)
    assert ticks == [2 * sim.SECOND, 4 * sim.SECOND, 6 * sim.SECOND,
                     8 * sim.SECOND]
    return ticks


def test_max_time_resumable():
    on_loop(_max_time_resumable)


def _wait_for_success_leaves_clock_clean(sim, loop):
    async def quick():
        await sim.sleep(sim.SECOND)
        return 1

    async def main():
        return await sim.wait_for(loop.spawn(quick()), 3600 * sim.SECOND)

    loop.run_coro(main())
    loop.run()
    assert loop.now == sim.SECOND
    return loop.now


def test_wait_for_success_leaves_clock_clean():
    on_loop(_wait_for_success_leaves_clock_clean)


def _queue_get_cancelled_does_not_lose_items(sim, loop):
    got = []

    async def getter(q):
        return await q.get()

    async def main():
        q = sim.Queue(loop)
        t1 = loop.spawn(getter(q))
        await sim.sleep(1)
        t1.cancel()
        q.put("x")
        await sim.sleep(1)
        t2 = loop.spawn(getter(q))
        got.append(await t2)

    loop.run_coro(main())
    assert got == ["x"]
    return got, loop.now


def test_queue_get_cancelled_does_not_lose_items():
    on_loop(_queue_get_cancelled_does_not_lose_items)


def _gather_cancel_propagates(sim, loop):
    async def hang():
        await loop.future()

    async def gatherer():
        await sim.gather(loop.spawn(hang()), loop.spawn(hang()))

    async def main():
        t = loop.spawn(gatherer())
        await sim.sleep(1)
        t.cancel()
        await sim.sleep(1)
        assert t.done

    loop.run_coro(main())
    return loop.now


def test_gather_cancel_propagates():
    on_loop(_gather_cancel_propagates)


def _queue_reroute_wakes_other_getter(sim, loop):
    got = []

    async def getter(q):
        got.append(await q.get())

    async def main():
        q = sim.Queue(loop)
        t1 = loop.spawn(getter(q))
        loop.spawn(getter(q))
        await sim.sleep(1)
        t1.cancel()
        q.put("x")
        await sim.sleep(1)
        assert got == ["x"]
        assert len(q) == 0

    loop.run_coro(main())
    return got, loop.now


def test_queue_reroute_wakes_other_getter():
    on_loop(_queue_reroute_wakes_other_getter)


def _gather_child_cancel_does_not_kill_gatherer(sim, loop):
    async def hang():
        await loop.future()

    async def quick():
        await sim.sleep(1)
        return "ok"

    async def main():
        t1 = loop.spawn(hang())
        t2 = loop.spawn(quick())
        g = loop.spawn(sim.gather(t1, t2))
        await sim.sleep(2)
        t1.cancel()
        with pytest.raises(sim.Cancelled):
            await g
        assert t2.done and t2.result() == "ok"
        return t2.result()

    return loop.run_coro(main()), loop.now


def test_gather_child_cancel_does_not_kill_gatherer():
    on_loop(_gather_child_cancel_does_not_kill_gatherer)


def _cancelled_timer_tombstones_compact(sim, loop):
    floor = sim.SimLoop.COMPACT_FLOOR
    n = 4 * floor
    timers = [loop.call_later(i + 1, lambda: None) for i in range(n)]
    assert len(loop._heap) == n
    for t in timers[:-4]:
        t.cancel()
    assert all(t.cancelled for t in timers[:-4])
    assert len(loop._heap) - 4 == loop._dead
    assert loop._dead <= 2 * floor
    assert len(loop._heap) < n // 2
    sizes = (len(loop._heap), loop._dead)
    fired = []
    for j, t in enumerate(timers[-4:]):
        t._entry[2] = lambda j=j: fired.append(j)
    loop.run()
    assert fired == [0, 1, 2, 3]
    return floor, sizes, fired, loop.now


def test_cancelled_timer_tombstones_compact():
    on_loop(_cancelled_timer_tombstones_compact)


def _cancel_below_floor_keeps_tombstones(sim, loop):
    timers = [loop.call_later(i + 1, lambda: None) for i in range(8)]
    for t in timers[:6]:
        t.cancel()
    assert len(loop._heap) == 8 and loop._dead == 6
    loop.run()
    assert loop._dead == 0 and not loop._heap
    return loop.now


def test_cancel_below_floor_keeps_tombstones():
    on_loop(_cancel_below_floor_keeps_tombstones)


def _same_instant_batch_drains_in_seq_order(sim, loop):
    fired = []
    loop.call_at(5, lambda: fired.append("a"))
    loop.call_at(5, lambda: (fired.append("b"),
                             loop.call_at(5, lambda: fired.append("d"))))
    loop.call_at(5, lambda: fired.append("c"))
    loop.run()
    assert fired == ["a", "b", "c", "d"]
    assert loop.now == 5
    return fired


def test_same_instant_batch_drains_in_seq_order():
    on_loop(_same_instant_batch_drains_in_seq_order)
