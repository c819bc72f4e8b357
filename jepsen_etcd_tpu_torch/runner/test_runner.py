"""The test harness: jepsen.core/run! re-designed for the hermetic runtime.

Sequence (SURVEY §3.1): DB setup on every node -> client open/setup per
worker -> generator interpretation (concurrent invokes + nemesis) ->
teardown -> checker.check over the recorded history -> artifacts.

``run_test`` runs the simulated cluster, with or without the streaming
check feed (``--stream``, runner/stream.py); a test with a live client
(``--client-type http|grpc``) goes to ``run_test_live``, which drives real
etcd processes (an external cluster, or the local control plane) on a
wall-clock loop, and ``run_soak`` checks one long-lived cluster window by
window. Every path checks through ``_analyze_and_save`` with the test's
checkers, so the live runs' checks run on the test's ``device`` too.
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
    """Run a composed test map; returns {valid?, results, history, dir}."""
    if test.get("client_type") in ("http", "grpc"):
        return run_test_live(test)
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
    result merge, artifact save, summary line. cluster is None for live
    runs and for a history the batched generator made (no simulated
    nodes, no trace); node_logs overrides the cluster-derived logs (the
    local control plane collects its own)."""
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


def run_test_live(test: dict) -> dict:
    """Run a composed test against REAL etcd processes (the
    CLI-drives-a-real-cluster shape of etcd.clj:246-257).

    Same sequence as run_test, on a WallLoop (runner/wall.py): real
    time, real I/O, no simulated cluster. With --db live,
    test['nodes'] are endpoint URLs of an external cluster and faults
    are rejected upstream (compose): no control plane. With --db
    local, nodes are names, the LocalDb control plane (db/local.py)
    spawns and faults the processes, and the nemesis runs exactly as
    in the sim path."""
    from .wall import WallLoop
    loop = WallLoop(seed=test.get("seed", 0))
    set_current_loop(loop)
    t0 = wall_time.time()
    store_dir = make_store_dir(test.get("store_base", "store"),
                               test.get("name", "test"))
    test["store_dir"] = store_dir
    test["cluster"] = None  # cluster-reading checkers no-op on None
    tel = _make_telemetry(test, store_dir)
    try:
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
            logger.info("Awaiting live cluster %s", test["nodes"])
            with tel_now.span("phase:setup", nodes=len(test["nodes"])):
                await db.setup(test)
                if nemesis_obj is not None:
                    await nemesis_obj.setup(test)
                await pool.setup_initial(test["concurrency"])
            logger.info("Running generator (wall clock)")
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
                # grace before the leak scan: same TIMEOUT-derived
                # bound as the sim path, so in-flight rpcs and
                # keepalive pumps (interval LEASE_TTL/3 < TIMEOUT) can
                # observe closure
                from .sim import sleep, SECOND
                from ..client.base import TIMEOUT
                await sleep(TIMEOUT + 1 * SECOND)
            return h

        history = loop.run_coro(main())
        _finish_stream(stream, history)
        sim_seconds = loop.now / 1e9
        task_leak = None
        try:
            check_task_leaks(loop)
        except SimError as e:
            logger.error("task leak detected: %s", e)
            task_leak = str(e)
        set_current_loop(None)
        loop.shutdown()
        # local-mode node logs come from the control plane's per-node
        # capture files (db.clj:234-242); plain live mode has no shell
        # on the nodes, so its log_files() is empty
        return _analyze_and_save(test, history, store_dir, None,
                                 task_leak, sim_seconds, t0,
                                 node_logs=db.log_files(test))
    finally:
        set_current_loop(None)
        loop.shutdown()
        telemetry.set_current(None)
        if tel is not None:
            tel.close()


class _SharedDb:
    """One live cluster across soak windows: the inner db's setup runs
    on the first window only, per-window teardown is a no-op, and
    ``close()`` performs the real teardown after the last window.
    Everything else (client_url, fault delivery, log collection)
    forwards to the inner control plane."""

    def __init__(self, inner):
        self.inner = inner
        self._ready = False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def setup(self, test: dict) -> None:
        if not self._ready:
            await self.inner.setup(test)
            self._ready = True

    async def teardown(self, test: dict) -> None:
        pass

    def close(self) -> None:
        if self._ready:
            self.inner.stop_all()


#: per-window register key-space stride: windows re-use the retained
#: cluster state, so a key checked in window w must never be generated
#: again in window w+1 (stale state would read as a false
#: linearizability violation)
SOAK_KEY_STRIDE = 100_000

#: soak net-fault kinds the schedule accepts (``kind`` or ``kind:arg``)
SOAK_NET_FAULTS = ("latency", "drop", "partition")


def _apply_soak_net_fault(plane, fault: str, nodes: list) -> None:
    """Program one window-long fault on the shared proxy plane.

    Spec is ``kind`` or ``kind:arg`` — ``latency[:delta-ms]`` (plus a
    fixed 10 ms jitter), ``drop[:probability]`` (per-chunk loss, every
    leg), ``partition`` (first node vs the rest, peer legs only).
    Unlike the per-window nemesis, these rules persist for the WHOLE
    window: degradation a start/stop generator cannot express.
    """
    kind, _, arg = fault.partition(":")
    if kind == "latency":
        plane.set_latency(float(arg or 40.0), 10.0)
    elif kind == "drop":
        plane.set_drop_prob(float(arg or 0.05))
    elif kind == "partition":
        plane.partition([[nodes[0]], list(nodes[1:])])
    else:
        raise ValueError(f"unknown soak net fault {fault!r}; "
                         f"kinds: {SOAK_NET_FAULTS}")


def run_soak(opts: dict, on_window=None) -> dict:
    """Sliding-window soak: check a long-running local cluster window
    by window with bounded memory.

    One shared control plane (``_SharedDb``) outlives every window;
    each window composes a fresh test with a rotated seed and register
    key offset, runs the normal live pipeline (streaming enabled by
    default so hints overlap generation), and is reduced to a summary
    dict immediately — the window's history is released before the
    next window generates, so memory is bounded by one window.

    ``soak_windows`` = 0 runs until interrupted (the CLI's soak mode);
    ``on_window(summary, out)`` sees each window's full result before
    release and may return truthy to stop the loop.
    """
    from ..compose import etcd_test
    base = dict(opts)
    base.pop("soak", None)
    windows_target = int(base.pop("soak_windows", 0) or 0)
    window_s = base.pop("soak_window_s", None)
    if base.get("client_type") not in ("http", "grpc"):
        raise ValueError(
            "soak mode checks a long-lived live cluster; use "
            "--client-type http/grpc with --db local (the fake-etcd "
            "stub works) or --db live")
    # long-lived network fault schedule: window w runs ENTIRELY under
    # schedule[w % len(schedule)], applied to the shared proxy plane
    # before the window starts and healed after it ends — the retained
    # cluster is what makes a whole-window fault meaningful
    net_faults = [f for f in (base.pop("soak_net_faults", None) or []) if f]
    if net_faults:
        if base.get("db_mode") != "local":
            raise ValueError(
                "soak net faults ride the userspace proxy plane: "
                "requires --db local")
        for f in net_faults:
            if f.partition(":")[0] not in SOAK_NET_FAULTS:
                raise ValueError(f"unknown soak net fault {f!r}; "
                                 f"kinds: {SOAK_NET_FAULTS}")
        base["net_proxy"] = True  # the plane must exist to program
    schedule = [None] + net_faults
    if base.get("db_mode") == "local" and not base.get("etcd_data_dir"):
        # windows >= 1 discard their freshly composed LocalDb; pin one
        # data root so the discards never mkdtemp roots of their own
        import tempfile
        base["etcd_data_dir"] = tempfile.mkdtemp(prefix="jepsen-soak-")
    # soak always streams: the window's pack/scan artifacts are ready
    # the moment generation ends, so per-window checking stays a
    # vectorized finalize (setdefault is not enough — the CLI threads
    # an explicit stream=False through opts_from_args)
    if not base.get("stream"):
        base["stream"] = True
    shared = None
    summaries: list[dict] = []
    all_valid = True
    w = 0
    try:
        while windows_target == 0 or w < windows_target:
            o = dict(base)
            if window_s:
                o["time_limit"] = window_s
            o["key_offset"] = (int(base.get("key_offset") or 0)
                               + w * SOAK_KEY_STRIDE)
            o["seed"] = int(base.get("seed") or 0) + w
            test = etcd_test(o)
            if shared is None:
                shared = _SharedDb(test["db"])
            test["db"] = shared
            test["name"] = f"{test['name']}-soak-w{w}"
            fault = schedule[w % len(schedule)]
            plane = getattr(shared, "plane", None)
            if fault is not None:
                if plane is None:
                    raise ValueError(
                        "soak net fault scheduled but the shared db "
                        "raised no proxy plane")
                _apply_soak_net_fault(plane, fault, sorted(o["nodes"]))
            try:
                out = run_test_live(test)
            finally:
                if fault is not None and plane is not None:
                    plane.heal()
            summary = {"window": w, "valid?": out["valid?"],
                       "soak-fault": fault,
                       "ops": len(out["history"]),
                       "dir": out["dir"],
                       "wall-seconds": out["wall-seconds"],
                       "key_offset": o["key_offset"],
                       "seed": o["seed"]}
            try:
                import resource
                summary["rss_peak_kb"] = resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss
            except Exception:
                pass
            summaries.append(summary)
            all_valid = all_valid and out["valid?"] is True
            logger.info("soak window %d: valid?=%s (%d ops)",
                        w, out["valid?"], summary["ops"])
            stop = on_window(summary, out) if on_window is not None \
                else None
            # release the window: the summary is all that survives
            out = None
            test = None
            w += 1
            if stop:
                break
    finally:
        if shared is not None:
            shared.close()
    return {"valid?": all_valid, "windows": summaries, "count": w}
