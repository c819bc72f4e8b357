"""The test harness: jepsen.core/run! re-designed for the hermetic runtime.

Sequence (SURVEY §3.1): DB setup on every node -> client open/setup per
worker -> generator interpretation (concurrent invokes + nemesis) ->
teardown -> checker.check over the recorded history -> artifacts.

The port runs the simulated cluster only, with or without the streaming
check feed (``--stream``, runner/stream.py). The reference's live runner
(``run_test_live``) and its soak windows (``run_soak``) come with a later
slice (ROADMAP A item 8).
"""

from __future__ import annotations

import logging
import time as wall_time
from typing import Any, Optional

from ..core.op import Op
from ..core.history import History
from ..sut.cluster import Cluster, ClusterConfig
from ..sut.errors import SimError
from .sim import SimLoop, set_current_loop
from .interpreter import interpret
from .store import make_store_dir, save_run
from . import telemetry
from .telemetry import Telemetry

logger = logging.getLogger("jepsen_etcd_tpu_torch.run")


def _tally_generate(tel, history, wall_s: float) -> None:
    """Pinned generation counters (OBSERVABILITY.md §counters):
    ``generate.ops_per_s`` is recorded events per generate-phase wall
    second; the ``columns.*`` counters say whether (and how much of)
    the run's op stream was emitted as SoA columns alongside the
    dicts. mode="max" keeps each a plain value, not a running sum."""
    tel.counter("generate.ops_per_s",
                round(len(history) / max(wall_s, 1e-9), 1), mode="max")
    cols = getattr(history, "columns", None)
    if cols is None:
        tel.counter("columns.disabled", 1, mode="max")
        return
    tel.counter("columns.events", len(cols), mode="max")
    tel.counter("columns.keyed", int((cols.key_id >= 0).sum()),
                mode="max")
    tel.counter("columns.extras", len(cols.extras), mode="max")


def _make_telemetry(test: dict, store_dir: str):
    """Install the run's telemetry recorder (``--no-telemetry`` opts
    out; every other run writes telemetry.jsonl with no flag needed).
    A campaign-minted ``trace_id``/``trace_parent`` stamps every
    record, and ``live_sink`` streams them to the campaign's live
    collector socket (best-effort datagrams)."""
    if test.get("no_telemetry"):
        return None
    import os
    tel = Telemetry(os.path.join(store_dir, "telemetry.jsonl"),
                    trace=test.get("trace_id"),
                    parent=test.get("trace_parent"),
                    sink=test.get("live_sink"))
    telemetry.set_current(tel)
    return tel


def _make_stream(test: dict):
    """The run's streaming check feed (``--stream``), or None. Always
    clears a stale ``_stream`` hint map first: hints are one run's
    artifacts and must never leak into a re-used test dict."""
    test.pop("_stream", None)
    if not test.get("stream"):
        return None
    from .stream import StreamFeed
    return StreamFeed(test, chunk_ops=test.get("stream_chunk_ops") or 0)


def _finish_stream(stream, history) -> None:
    """Drain + join the feed and install its reuse hints; its own span
    so run reports separate residual finalize cost from phase:check."""
    if stream is None:
        return
    with telemetry.current().span("phase:stream-finalize",
                                  ops=len(history)) as sp:
        hints = stream.finish(history)
        sp.set(chunks=stream.chunks,
               hints=sorted(k for k in hints if k != "stats"))


class ClientPool:
    """Per-thread workload clients with jepsen's lifecycle: a worker whose
    process crashes (:info) gets a fresh client on its next op."""

    def __init__(self, test: dict):
        self.test = test
        self.proto = test["client"]
        self.by_thread: dict[int, tuple[int, Any]] = {}

    def node_for(self, process: int) -> str:
        nodes = self.test["nodes"]
        return nodes[process % len(nodes)]

    async def setup_initial(self, concurrency: int) -> None:
        for t in range(concurrency):
            c = self.proto.open(self.test, self.node_for(t))
            self.by_thread[t] = (t, c)
        # client setup! runs once per initial client before ops start
        for t in range(concurrency):
            await self.by_thread[t][1].setup(self.test)

    def client_for(self, process: int) -> Any:
        t = process % self.test["concurrency"]
        got = self.by_thread.get(t)
        if got is not None and got[0] == process:
            return got[1]
        if got is not None:
            got[1].close(self.test)
        c = self.proto.open(self.test, self.node_for(process))
        self.by_thread[t] = (process, c)
        return c

    async def teardown(self) -> None:
        for t, (p, c) in list(self.by_thread.items()):
            try:
                await c.teardown(self.test)
            finally:
                c.close(self.test)


#: client-side task-name prefixes; anything of these still live after
#: teardown + grace is a leaked client task (the sshj thread-leak
#: analog, support.clj:57-72)
_CLIENT_TASK_PREFIXES = ("rpc-", "keepalive-", "worker-", "evget")


def check_task_leaks(loop, where: str = "post-run") -> None:
    """Scan the SimLoop for live client tasks and throw, like the
    reference's pre-run sshj thread-leak scan (support.clj:57-72 throws
    :sshj-thread-leak with the offending stacks)."""
    leaked = [t.name for t in loop.tasks
              if not t.done and t.name.startswith(_CLIENT_TASK_PREFIXES)]
    if leaked:
        raise SimError("task-leak",
                       f"{where}: live client tasks: {sorted(leaked)[:16]} "
                       f"({len(leaked)} total)")


def run_test(test: dict) -> dict:
    """Run a composed test map on the simulated cluster; returns
    {valid?, results, history, dir}."""
    seed = test.get("seed", 0)
    loop = SimLoop(seed=seed)
    set_current_loop(loop)
    t0 = wall_time.time()
    # The sim allocates millions of short-lived objects per run; cyclic GC
    # walks the ever-growing live graph (history, logs, WAL records) on
    # allocation thresholds and was measured costing 20-40% of generation
    # wall time, with multi-second run-to-run variance. Refcounting
    # reclaims the sim's true garbage; one collect at the end handles the
    # few cycles (tasks/coroutines).
    import gc
    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.disable()
    # store dir exists before ops run, so debug-mode provenance can embed
    # the run's dir name in written values (the reference's store/path is
    # likewise available during the run, append.clj:40)
    store_dir = make_store_dir(test.get("store_base", "store"),
                               test.get("name", "test"))
    test["store_dir"] = store_dir
    tel = _make_telemetry(test, store_dir)
    try:
        # thread the reference's SUT knobs from opts into the cluster
        # (etcd.clj:164,197-204 -> db.clj:88-99); an explicit
        # cluster_config still wins for tests that build their own
        cluster = Cluster(loop, list(test["nodes"]),
                          test.get("cluster_config") or ClusterConfig(
                              lazyfs=bool(test.get("lazyfs")),
                              snapshot_count=(
                                  100 if test.get("snapshot_count") is None
                                  else int(test["snapshot_count"])),
                              unsafe_no_fsync=bool(
                                  test.get("unsafe_no_fsync")),
                              corrupt_check=bool(
                                  test.get("corrupt_check"))))
        test["cluster"] = cluster
        if test.get("tcpdump"):
            # network-event trace (the --tcpdump analog, db.clj:276-277)
            # streaming straight to the run dir — events are never
            # buffered past the write-behind window
            import os
            from .trace import NetTrace
            cluster.tracer = NetTrace(
                loop, path=os.path.join(store_dir, "trace.jsonl"))
        db = test["db"]
        pool = ClientPool(test)
        nemesis_obj = test.get("nemesis")
        stream = _make_stream(test)

        async def invoke(process: int, op: Op) -> Op:
            client = pool.client_for(process)
            return await client.invoke(test, op)

        nemesis_invoke = None
        if nemesis_obj is not None:
            async def nemesis_invoke(op: Op) -> Op:
                return await nemesis_obj.invoke(test, op)

        async def main() -> History:
            tel_now = telemetry.current()
            logger.info("Setting up DB on %s", test["nodes"])
            with tel_now.span("phase:setup", nodes=len(test["nodes"])):
                await db.setup(test)
                if nemesis_obj is not None:
                    await nemesis_obj.setup(test)
                await pool.setup_initial(test["concurrency"])
            logger.info("Running generator")
            g0 = wall_time.time()
            with tel_now.span("phase:generate") as sp:
                h = await interpret(test, test["generator"], invoke,
                                    test["concurrency"],
                                    nemesis_invoke=nemesis_invoke,
                                    stream=stream)
                sp.set(ops=len(h))
            _tally_generate(tel_now, h, wall_time.time() - g0)
            with tel_now.span("phase:teardown"):
                await pool.teardown()
                if nemesis_obj is not None:
                    await nemesis_obj.teardown(test)
                await db.teardown(test)
                # grace: let closed clients' pumps observe closure and
                # timed-out rpcs cancel before the leak scan — derived
                # from the client timeout so raising TIMEOUT can't cause
                # spurious task-leak reports
                from .sim import sleep, SECOND
                from ..client.base import TIMEOUT
                await sleep(TIMEOUT + 1 * SECOND)
            return h

        history = loop.run_coro(main())
        _finish_stream(stream, history)
        sim_seconds = loop.now / 1e9
        # leak scan AFTER the run, recorded into results rather than
        # thrown — a leak must not destroy the run's artifacts (they're
        # the evidence needed to debug it)
        task_leak = None
        try:
            check_task_leaks(loop)
        except SimError as e:
            logger.error("task leak detected: %s", e)
            task_leak = str(e)
        set_current_loop(None)
        return _analyze_and_save(test, history, store_dir, cluster,
                                 task_leak, sim_seconds, t0)
    finally:
        set_current_loop(None)
        telemetry.set_current(None)
        if tel is not None:
            tel.close()
        if gc_was_enabled:
            # re-enable only, no collect: at this point the run's object
            # graph is still reachable through the caller's test dict, so
            # a collect here would scan millions of live objects and free
            # almost nothing. Ambient GC reclaims the cycles (tasks,
            # coroutine frames) once the caller drops the test.
            gc.enable()


def _analyze_and_save(test: dict, history, store_dir: str, cluster,
                      task_leak, sim_seconds: float, t0: float,
                      node_logs: Optional[dict] = None) -> dict:
    """The run's epilogue: checker pass, task-leak / corrupt-check
    result merge, artifact save, summary line. cluster is None for a
    history the batched generator made (no simulated nodes, no trace);
    node_logs overrides the cluster-derived logs."""
    logger.info("Analyzing %d ops (history in %s)", len(history), store_dir)
    tel = telemetry.current()
    # service=True means device-bound checks may ship to a shared
    # checker service — this run's check wall time then
    # includes socket round-trip + coalescing-tick queue wait, not
    # just local device work (see service.queue_wait_s on the
    # service side)
    with tel.span("phase:check", ops=len(history),
                  service=bool(test.get("checker_service"))):
        results = test["checker"].check(test, history,
                                        {"store_dir": store_dir})
    if task_leak is not None:
        results["task-leak"] = {"valid?": False, "error": task_leak}
        results["valid?"] = False
    if test.get("corrupt_check") and cluster is not None:
        # definite verdict from the runtime corruption monitor
        # (etcd.clj:164); the fatal alarm log line is independently
        # caught by the crash-pattern checker
        alarms = list(cluster.corruption_alarms)
        results["corrupt-check"] = {"valid?": not alarms, "alarms": alarms}
        if alarms:
            results["valid?"] = False
    if node_logs is None:
        node_logs = {} if cluster is None else {
            name: list(node.etcd_log)
            for name, node in cluster.nodes.items()}
    # the trace streams during the run; close it and fold its totals
    # into results BEFORE save_run so results.json carries them
    if cluster is not None and cluster.tracer is not None:
        cluster.tracer.close()
        results["net-trace"] = cluster.tracer.summary()
    if tel.enabled:
        results["telemetry"] = tel.summary()
    with tel.span("phase:save"):
        save_run(store_dir, test, history, results, node_logs)
    wall = wall_time.time() - t0
    logger.info("Run complete: valid?=%s (%d ops, %.1f sim-s, %.2f wall-s)",
                results.get("valid?"), len(history), sim_seconds, wall)
    return {"valid?": results.get("valid?"), "results": results,
            "history": history, "dir": store_dir,
            "sim-seconds": sim_seconds, "wall-seconds": wall}
