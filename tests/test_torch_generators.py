"""Twin of the reference's ``tests/test_generators.py`` on the port's
``generators/`` and ``runner/interpreter.py``: each generator runs
through the interpreter on both packages' virtual-time loops (``both``)
with the reference's assertions, and the two histories' JSONL bytes are
equal."""

from collections import Counter

from test_torch_fixtures import both, mod, one_torch_thread  # noqa: F401


class Pkg:
    """One package's generator combinators, loop and interpreter."""

    def __init__(self, pkg):
        self.g = mod(pkg, "generators")
        self.sim = mod(pkg, "runner.sim")
        self.op = mod(pkg, "core.op")
        self.interpret = mod(pkg, "runner.interpreter").interpret
        self.SECOND = self.sim.SECOND

    def run_gen(self, gen, concurrency=4, seed=0, latency=None,
                invoke=None, nemesis_invoke=None, test=None):
        sim = self.sim
        latency = latency or int(0.05 * sim.SECOND)
        loop = sim.SimLoop(seed=seed)
        sim.set_current_loop(loop)

        async def default_invoke(process, op):
            await sim.sleep(loop.rng.randint(1, latency))
            return op.evolve(type="ok")

        async def main():
            return await self.interpret(test or {}, gen,
                                        invoke or default_invoke,
                                        concurrency,
                                        nemesis_invoke=nemesis_invoke)

        try:
            return loop.run_coro(main())
        finally:
            sim.set_current_loop(None)


def on_both(body):
    """``body(Pkg)`` on the port and the reference; it returns a
    History, whose JSONL bytes must be equal."""
    return both(lambda pkg: body(Pkg(pkg)).to_jsonl())


def r(test, ctx):
    return {"f": "read", "value": None}


def w(test, ctx):
    return {"f": "write", "value": ctx.rng.randint(0, 4)}


def _limit_and_mix(P):
    h = P.run_gen(P.g.limit(20, P.g.mix([r, w])))
    invokes = h.invokes()
    assert len(invokes) == 20
    assert {op.f for op in invokes} == {"read", "write"}
    assert all(h.completion(op) is not None for op in invokes)
    return h


def test_limit_and_mix():
    on_both(_limit_and_mix)


def _reserve_partitions_threads(P):
    g = P.g
    gen = g.limit(40, g.reserve(2, g.repeat({"f": "read"}),
                                g.repeat({"f": "write"})))
    h = P.run_gen(gen, concurrency=4)
    for op in h.invokes():
        thread = op.process % 4
        if op.f == "read":
            assert thread in (0, 1)
        else:
            assert thread in (2, 3)
    return h


def test_reserve_partitions_threads():
    on_both(_reserve_partitions_threads)


def _stagger_rate(P):
    gen = P.g.limit(50, P.g.stagger(int(0.1 * P.SECOND), r))
    h = P.run_gen(gen, concurrency=4)
    times = [op.time for op in h.invokes()]
    total = (times[-1] - times[0]) / P.SECOND
    assert 2.0 < total < 10.0
    return h


def test_stagger_rate():
    on_both(_stagger_rate)


def _time_limit_cuts_off(P):
    gen = P.g.time_limit(1 * P.SECOND,
                         P.g.stagger(int(0.01 * P.SECOND), r))
    h = P.run_gen(gen, concurrency=4)
    assert len(h) > 10
    assert all(op.time <= 1 * P.SECOND for op in h.invokes())
    return h


def test_time_limit_cuts_off():
    on_both(_time_limit_cuts_off)


def _phases_barrier(P):
    g = P.g
    gen = g.phases(g.limit(8, g.repeat({"f": "a"})),
                   g.limit(8, g.repeat({"f": "b"})))
    h = P.run_gen(gen, concurrency=4)
    assert len([op for op in h.invokes() if op.f == "a"]) == 8
    assert len([op for op in h.invokes() if op.f == "b"]) == 8
    a_completes = [op.time for op in h if op.is_completion and op.f == "a"]
    b_invokes = [op.time for op in h if op.is_invoke and op.f == "b"]
    assert a_completes and b_invokes
    assert min(b_invokes) >= max(a_completes)
    return h


def test_phases_barrier():
    on_both(_phases_barrier)


def _each_thread(P):
    h = P.run_gen(P.g.each_thread({"f": "final"}), concurrency=4)
    invs = h.invokes()
    assert len(invs) == 4
    assert {op.process % 4 for op in invs} == {0, 1, 2, 3}
    return h


def test_each_thread():
    on_both(_each_thread)


def _nemesis_routing(P):
    sim, g = P.sim, P.g

    async def nem_invoke(op):
        await sim.sleep(int(0.02 * P.SECOND))
        return op.evolve(type="info")

    gen = g.time_limit(2 * P.SECOND, g.nemesis(
        g.repeat({"f": "kill"}), g.stagger(int(0.05 * P.SECOND), r)))
    h = P.run_gen(gen, concurrency=2, nemesis_invoke=nem_invoke)
    kills = [op for op in h if op.f == "kill"]
    reads = [op for op in h if op.f == "read"]
    assert kills and reads
    assert all(op.process == P.op.NEMESIS for op in kills)
    assert all(isinstance(op.process, int) for op in reads)
    return h


def test_nemesis_routing():
    on_both(_nemesis_routing)


def _info_bumps_process(P):
    count = [0]

    async def flaky(process, op):
        await P.sim.sleep(int(0.01 * P.SECOND))
        count[0] += 1
        if count[0] == 3:
            return op.evolve(type="info", error="timeout")
        return op.evolve(type="ok")

    h = P.run_gen(P.g.limit(10, r), concurrency=2, invoke=flaky)
    procs = {op.process for op in h.invokes()}
    assert any(p >= 2 for p in procs)
    assert all(h.completion(op) is not None for op in h.invokes())
    return h


def test_info_bumps_process():
    on_both(_info_bumps_process)


def _concurrent_generator_keys(P):
    g = P.g
    gen = g.independent.concurrent_generator(
        2, range(100), lambda k: g.limit(6, g.mix([r, w])))
    h = P.run_gen(g.time_limit(20 * P.SECOND, gen), concurrency=4)
    invs = h.invokes()
    assert invs
    keys = {op.value[0] for op in invs}
    assert len(keys) >= 2
    for op in invs:
        assert isinstance(op.value, tuple) and len(op.value) == 2
    per_key = Counter(op.value[0] for op in invs)
    assert all(c <= 6 for c in per_key.values())
    k0 = sorted(keys)[0]
    sub = g.independent.subhistory(h, k0)
    assert sub and not isinstance(sub[0].value, tuple)
    return h


def test_concurrent_generator_keys():
    on_both(_concurrent_generator_keys)


def _sleep_gen_and_log(P):
    g = P.g
    gen = g.phases(g.sleep_gen(1 * P.SECOND), g.log("hello"),
                   g.limit(2, r))
    h = P.run_gen(gen, concurrency=2)
    invs = h.invokes()
    assert len(invs) == 2
    assert all(op.time >= 1 * P.SECOND for op in invs)
    assert all(op.f != "log" for op in h)
    return h


def test_sleep_gen_and_log():
    on_both(_sleep_gen_and_log)


def _determinism_full_stack(P):
    def once_run():
        gen = P.g.time_limit(3 * P.SECOND, P.g.stagger(
            int(0.02 * P.SECOND), P.g.mix([r, w])))
        return P.run_gen(gen, concurrency=4, seed=123)

    h = once_run()
    assert h.to_jsonl() == once_run().to_jsonl()
    return h


def test_determinism_full_stack():
    on_both(_determinism_full_stack)


def _fngen_finite_source_no_loss(P):
    items = list(range(12))

    def src(test, ctx):
        return {"f": "item", "value": items.pop(0)} if items else None

    h = P.run_gen(src, concurrency=2, latency=int(0.2 * P.SECOND))
    assert sorted(op.value for op in h.invokes()) == list(range(12))
    return h


def test_fngen_finite_source_no_loss():
    on_both(_fngen_finite_source_no_loss)


def _explicit_process_busy_thread_no_loss(P):
    h = P.run_gen(P.g.limit(5, P.g.repeat({"f": "ping", "process": 0})),
                  concurrency=2, latency=int(0.1 * P.SECOND))
    assert len([op for op in h.invokes() if op.f == "ping"]) == 5
    return h


def test_explicit_process_busy_thread_no_loss():
    on_both(_explicit_process_busy_thread_no_loss)


def _reserve_exact_thread_count_terminates(P):
    g = P.g
    gen = g.reserve(2, g.limit(4, g.repeat({"f": "a"})),
                    g.limit(4, g.repeat({"f": "b"})))
    h = P.run_gen(gen, concurrency=2)
    assert len([op for op in h.invokes() if op.f == "a"]) == 4
    assert len([op for op in h.invokes() if op.f == "b"]) == 0
    return h


def test_reserve_exact_thread_count_terminates():
    on_both(_reserve_exact_thread_count_terminates)


def _queued_op_after_info_gets_fresh_process(P):
    calls = [0]

    async def crashy(process, op):
        calls[0] += 1
        await P.sim.sleep(int(0.05 * P.SECOND))
        if calls[0] == 1:
            return op.evolve(type="info", error="timeout")
        return op.evolve(type="ok")

    h = P.run_gen(P.g.limit(3, P.g.repeat({"f": "w", "process": 0})),
                  concurrency=2, invoke=crashy)
    invs = list(h.invokes())
    assert invs[0].process == 0
    assert all(op.process > 0 and op.process % 2 == 0 for op in invs[1:])
    assert all(h.completion(op) is not None for op in invs)
    return h


def test_queued_op_after_info_gets_fresh_process():
    on_both(_queued_op_after_info_gets_fresh_process)
