"""Fleet campaigns: seeds x workloads x nemeses over a process pool.

The reference's ``test-all`` sweeps its matrix serially
(etcd.clj:226-244); at fleet scale the sweep IS the workload, so this
module fans the expanded matrix over a bounded pool of spawned worker
processes (one ``run_test`` per spec, per-run store dirs under the
shared base — ``make_store_dir`` claims ids atomically) and, when the
checker service is on, hosts ONE device-owning
``runner/checker_service.CheckerService`` whose socket every worker's
checker submits packed histories to — device dispatches are paid per
(bucket, width, tick), not per run (PERF.md has the amortization
accounting).

Workers are SPAWNED, never forked: every worker imports its own
torch, and forking a process with live device state (a CUDA context)
or live threads (the service, telemetry writers) is undefined. The
spawn import cost (~seconds) is paid once per pool slot and amortizes
over the campaign.

The port's runs check on their spec's ``device`` (``opts["device"]``:
the card unless ``"cpu"`` is named). :func:`run_campaign` resolves
every spec's device before the collector, the service or the pool
starts, so a missing card raises once instead of failing every run.
Epoch-v3 cells generate on that device (``generate_for_opts(...,
device=...)``).

Artifacts: the campaign itself owns a store dir
(``store/<name>/<id>/``) holding ``campaign.json`` (per-run rows +
failure summary + service stats) and ``telemetry.jsonl``
(``campaign.*`` counters, one ``campaign.run`` event per run, and the
service's counters folded in at the end). ``serve.py /aggregate``
reads these for the perf-trends-across-campaigns section.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from collections import deque
from typing import Optional

from .store import _scrub, link_latest, make_store_dir
from .telemetry import Hist, Telemetry

logger = logging.getLogger("jepsen_etcd_tpu_torch.campaign")

#: datagram backlog bound for the live collector: past it records are
#: shed and counted (live.dropped) — the fleet never blocks on the
#: dashboard
LIVE_QUEUE_MAX = 8192

#: live.json snapshot cadence (seconds)
LIVE_SNAPSHOT_S = 0.5


class LiveCollector:
    """Bounded, lossy aggregation of the fleet's live telemetry.

    Campaign workers and the checker service stream their records as
    JSON datagrams to an AF_UNIX socket this collector owns (see
    ``Telemetry(sink=...)``); two threads (receive -> bounded queue ->
    fold) turn them into an atomic ``live.json`` snapshot that
    ``serve.py /live`` tails over SSE. Everything here is best-effort:
    a slow collector sheds datagrams (counted), a torn or non-JSON
    datagram is counted and skipped, and the campaign's correctness
    artifacts never depend on this path. All shared state is mutated
    under ``_cv`` only.
    """

    def __init__(self, cdir: str, trace: Optional[str] = None):
        self.dir = cdir
        self.path = os.path.join(cdir, "live.sock")
        self.json_path = os.path.join(cdir, "live.json")
        self.trace = trace
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._stopped = False
        self.records = 0
        self.dropped = 0
        self.bad = 0
        # fold state (all under _cv): per-run progress, service
        # occupancy, summed counters, merged histograms
        self._runs: dict = {}
        self._service: dict = {}
        self._counters: dict = {}
        self._hists: dict = {}
        self._sock: Optional[socket.socket] = None
        self._threads: list = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "LiveCollector":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        try:
            os.unlink(self.path)
        except OSError:
            pass
        s.bind(self.path)
        s.settimeout(0.25)  # poll the stop flag; close() never hangs
        try:  # a deeper kernel buffer before the queue bound engages
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
        except OSError:
            pass
        recv = threading.Thread(target=self._recv_loop,
                                name="campaign-live-recv", daemon=True)
        fold = threading.Thread(target=self._fold_loop,
                                name="campaign-live-fold", daemon=True)
        with self._cv:
            self._sock = s
            self._threads = [recv, fold]
        recv.start()
        fold.start()
        self._snapshot()  # /live has something to show immediately
        return self

    def close(self) -> dict:
        """Stop both threads, write the final ``done`` snapshot, and
        return ``{records, dropped, bad}``."""
        with self._cv:
            if not self._stopped:
                self._stopped = True
                self._cv.notify_all()
            threads = list(self._threads)
            sock = self._sock
        for t in threads:
            t.join(timeout=10)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._snapshot(done=True)
        try:
            os.unlink(self.path)
        except OSError:
            pass
        with self._cv:
            return {"records": self.records, "dropped": self.dropped,
                    "bad": self.bad}

    # -- receive side --------------------------------------------------------
    def _recv_loop(self) -> None:
        while True:
            with self._cv:
                if self._stopped:
                    return
                sock = self._sock
            try:
                data, _ = sock.recvfrom(1 << 20)
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed by close()
            with self._cv:
                if len(self._queue) >= LIVE_QUEUE_MAX:
                    self.dropped += 1
                else:
                    self._queue.append(data)
                    self._cv.notify_all()

    # -- fold side -----------------------------------------------------------
    def _fold_loop(self) -> None:
        last_snap = 0.0
        while True:
            with self._cv:
                if not self._queue and not self._stopped:
                    # bounded wait, not until-work: idle campaigns
                    # still refresh the snapshot's heartbeat
                    self._cv.wait(timeout=LIVE_SNAPSHOT_S)
                if self._stopped and not self._queue:
                    return
                batch = list(self._queue)
                self._queue.clear()
            for data in batch:
                try:
                    rec = json.loads(data.decode("utf-8", "replace"))
                    if not isinstance(rec, dict):
                        raise ValueError("record is not an object")
                except (ValueError, UnicodeDecodeError):
                    with self._cv:
                        self.bad += 1
                    continue
                self._fold(rec)
            now = time.monotonic()
            if now - last_snap >= LIVE_SNAPSHOT_S:
                self._snapshot()
                last_snap = now

    def _fold(self, rec: dict) -> None:
        # _cv is a Condition over an RLock, so this nests under the
        # drain loop's hold too
        kind = rec.get("kind")
        name = rec.get("name") or ""
        trace = rec.get("trace")
        with self._cv:
            self.records += 1
            if kind == "span":
                if trace is not None:
                    st = self._runs.setdefault(trace, {"spans": 0})
                    st["spans"] += 1
                    st["last"] = name
                    if name.startswith("phase:"):
                        st["phase"] = name[len("phase:"):]
                if name == "service.tick":
                    attrs = rec.get("attrs") or {}
                    self._service = {
                        "ticks": self._service.get("ticks", 0) + 1,
                        "packs": attrs.get("packs"),
                        "requests": attrs.get("requests"),
                        "groups": attrs.get("groups"),
                        "runs": attrs.get("runs"),
                        "device": attrs.get("device"),
                        "placement": attrs.get("placement"),
                        "sharded": attrs.get("sharded"),
                    }
                dur = rec.get("dur_s")
                if name in ("wgl.check_packed", "stream.chunk",
                            "service.tick") and isinstance(dur,
                                                           (int, float)):
                    self._hists.setdefault(name, Hist()).record(dur)
            elif kind == "counter":
                v = rec.get("value")
                if isinstance(v, (int, float)):
                    self._counters[name] = \
                        self._counters.get(name, 0) + v
            elif kind == "hist":
                # a run (or the service) closed and flushed its
                # histograms: merge them so /live sparklines cover op
                # latencies too
                key = ("op.latency.*" if name.startswith("op.latency.")
                       else name)
                self._hists.setdefault(key, Hist()).merge(
                    Hist.from_dict(rec))
            elif kind == "event" and name == "campaign.run" \
                    and trace is not None:
                st = self._runs.setdefault(trace, {"spans": 0})
                st.update(rec.get("attrs") or {})

    def note_row(self, row: dict) -> None:
        """Campaign-side fold of a finished row (authoritative status —
        works even when every datagram was shed)."""
        trace = row.get("trace")
        if trace is None:
            return
        with self._cv:
            st = self._runs.setdefault(trace, {"spans": 0})
            st["status"] = row.get("status")
            st["valid"] = row.get("valid")
            st["index"] = row.get("index")
            if row.get("host") is not None:
                st["host"] = row.get("host")
        self._snapshot()

    def _snapshot(self, done: bool = False) -> None:
        """Atomically publish live.json (tmp + rename; readers never
        see a torn file)."""
        with self._cv:
            snap = {
                "campaign": self.trace,
                "t": time.time(),
                "records": self.records,
                "dropped": self.dropped,
                "bad": self.bad,
                "runs": {k: dict(v) for k, v in self._runs.items()},
                "service": dict(self._service),
                "counters": dict(self._counters),
                "hists": {k: h.to_dict()
                          for k, h in self._hists.items()},
                "done": done,
            }
        tmp = self.json_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(snap, f, default=repr)
            os.replace(tmp, self.json_path)
        except OSError:
            pass  # dashboard-only artifact: never fail the campaign


def campaign_specs(base_opts: dict, workloads: list,
                   nemeses: list, runs_per_cell: int = 1,
                   seed0: int = 0) -> list[dict]:
    """Expand the test-all matrix into one spec per run. Seeds are
    distinct across the whole campaign (seed0 + running index) so no
    two runs replay the same history."""
    specs = []
    for nem in nemeses:
        for wl in workloads:
            for i in range(runs_per_cell):
                opts = dict(base_opts)
                opts.update({"workload": wl, "nemesis": list(nem),
                             "seed": seed0 + len(specs)})
                specs.append({"index": len(specs), "opts": opts})
    return specs


#: the campaign-row histogram groups (per-row p50/p95/p99 for gen,
#: check, and queue-wait): label -> matcher over
#: the run summary's hist names
_ROW_HIST_GROUPS = (
    ("gen", lambda n: n.startswith("op.latency.")),
    ("check", lambda n: n == "wgl.check_packed"),
    ("queue_wait", lambda n: n == "service.queue_wait_s"),
)


def _row_hists(tel_sum: dict) -> tuple[dict, dict]:
    """(hists, p) for one run's telemetry summary: per-group merged
    sparse histograms and their [p50, p95, p99] triples. Groups with
    no observations are omitted."""
    hists = tel_sum.get("hists") or {}
    out_h: dict = {}
    out_p: dict = {}
    for label, match in _ROW_HIST_GROUPS:
        ds = [d for n, d in hists.items() if match(n)]
        if not ds:
            continue
        h = Hist()
        for d in ds:
            h.merge(Hist.from_dict(d))
        d = h.to_dict()
        out_h[label] = d
        out_p[label] = [d["p50"], d["p95"], d["p99"]]
    return out_h, out_p


def _row_net(counters: dict) -> dict:
    """The lossy-link diagnosis triple surfaced on /aggregate."""
    return {"dropped_chunks": int(counters.get("net.dropped_chunks", 0)),
            "accept_errors": int(counters.get("net.accept_errors", 0)),
            "delayed_bytes": int(counters.get("net.delayed_bytes", 0))}


def _pool_run(spec: dict) -> dict:
    """One campaign run, executed inside a pool worker (top-level so
    spawn can pickle it by module path). Returns a compact summary row
    — never the history — so result transfer stays cheap."""
    opts = dict(spec["opts"])
    row: dict = {"index": spec["index"], "workload": opts.get("workload"),
                 "nemesis": opts.get("nemesis"), "seed": opts.get("seed"),
                 "trace": opts.get("trace_id"),
                 # histories from a live cluster are observed, not
                 # generated — no generator epoch applies there
                 "gen-epoch": (None if opts.get("client_type")
                               in ("http", "grpc") else "epoch-v1")}
    try:
        from ..compose import etcd_test
        from .test_runner import run_test
        test = etcd_test(opts)
        out = run_test(test)
    except NotImplementedError as e:
        row.update(status="skipped", error=str(e))
        return row
    except Exception as e:  # a crashed run must not kill the sweep
        logger.exception("campaign run %s failed", spec["index"])
        row.update(status="error", error=repr(e))
        return row
    tel = (out.get("results") or {}).get("telemetry") or {}
    counters = tel.get("counters") or {}
    phases = tel.get("phases") or {}
    hists, percentiles = _row_hists(tel)
    row.update(
        status="done", valid=out["valid?"], dir=out["dir"],
        ops=len(out["history"]), wall_s=round(out["wall-seconds"], 3),
        gen_ops_per_s=counters.get("generate.ops_per_s"),
        check_s=round(phases.get("check", 0.0), 4),
        dispatches=int(counters.get("wgl.dispatches", 0)
                       + counters.get("mxu.dispatches", 0)),
        service_fallbacks=int(counters.get("service.fallback", 0)),
        service_shipped=int(counters.get("service.shipped", 0)),
        service_queue_wait_s=round(
            counters.get("service.queue_wait_s", 0.0), 6),
        engines={k[len("engine."):]: v for k, v in counters.items()
                 if k.startswith("engine.")},
        net=_row_net(counters),
        hists=hists, p=percentiles,
    )
    return row


def _batchable(opts: dict) -> bool:
    """True when the batched generator (simbatch/) can serve this
    spec: an epoch-v2 (lockstep numpy) or epoch-v3 (jitted device) sim
    run of a supported workload — generate_for_opts routes between the
    two engines by the declared epoch. Live clusters produce observed
    histories (no generator epoch), and --stream/--soak runs
    interleave generation with the run itself, so all of those fall
    back to the epoch-v1 event loop."""
    if opts.get("gen_epoch") not in ("epoch-v2", "epoch-v3"):
        return False
    if opts.get("client_type") in ("http", "grpc"):
        return False
    if opts.get("db_mode") not in (None, "sim"):
        return False
    if opts.get("soak") or opts.get("stream"):
        return False
    from ..simbatch import supports
    return supports(opts.get("workload", "register"))


def _run_batched_cell(cell_specs: list, tel: Telemetry,
                      genbatch: dict) -> list:
    """One batched-generator cell: every spec in ``cell_specs`` shares
    a (workload, nemesis) point of the matrix, so their seeds generate
    in ONE lockstep columnar pass; each history then gets the normal
    per-run epilogue (checker, store dir, artifacts) in this process.
    Returns one summary row per spec, same shape as ``_pool_run``."""
    import time as wall_time

    from ..compose import etcd_test
    from ..simbatch import generate_for_opts
    from . import telemetry
    from .store import make_store_dir
    from .test_runner import _analyze_and_save, _make_telemetry

    seeds = [int(s["opts"].get("seed", 0)) for s in cell_specs]
    opts0 = dict(cell_specs[0]["opts"])
    g0 = wall_time.time()
    gen = generate_for_opts(opts0, seeds, device=opts0.get("device"))
    gen_wall = wall_time.time() - g0
    agg = round(gen["events"] / max(gen_wall, 1e-9), 1)
    tel.counter("genbatch.cells")
    tel.counter("genbatch.seeds", len(seeds))
    tel.counter("genbatch.steps", gen["steps"])
    tel.counter("genbatch.events", gen["events"])
    tel.counter("genbatch.compactions", gen["compactions"])
    tel.counter("genbatch.ops_per_s", agg, mode="max")
    genbatch["cells"] += 1
    genbatch["seeds"] += len(seeds)
    genbatch["events"] += gen["events"]
    genbatch["ops_per_s"] = max(genbatch["ops_per_s"], agg)
    genbatch["epoch"] = gen["epoch"]
    rows = []
    for spec, history in zip(cell_specs, gen["histories"]):
        opts = dict(spec["opts"])
        row: dict = {"index": spec["index"],
                     "workload": opts.get("workload"),
                     "nemesis": opts.get("nemesis"),
                     "seed": opts.get("seed"),
                     "trace": opts.get("trace_id"),
                     "gen-epoch": gen["epoch"]}
        t0 = wall_time.time()
        run_tel = None
        try:
            test = etcd_test(opts)
            test["cluster"] = None
            store_dir = make_store_dir(opts.get("store_base", "store"),
                                       test.get("name", "test"))
            test["store_dir"] = store_dir
            run_tel = _make_telemetry(test, store_dir)
            cols = history.columns
            sim_seconds = (float(cols.time[-1]) / 1e9 if len(cols)
                           else 0.0)
            out = _analyze_and_save(test, history, store_dir,
                                    cluster=None, task_leak=None,
                                    sim_seconds=sim_seconds, t0=t0,
                                    node_logs={})
        except Exception as e:  # a crashed run must not kill the cell
            logger.exception("batched campaign run %s failed",
                             spec["index"])
            row.update(status="error", error=repr(e))
            rows.append(row)
            continue
        finally:
            telemetry.set_current(None)
            if run_tel is not None:
                run_tel.close()
        tel_sum = (out.get("results") or {}).get("telemetry") or {}
        counters = tel_sum.get("counters") or {}
        phases = tel_sum.get("phases") or {}
        hists, percentiles = _row_hists(tel_sum)
        row.update(
            status="done", valid=out["valid?"], dir=out["dir"],
            ops=len(out["history"]),
            wall_s=round(out["wall-seconds"], 3),
            gen_ops_per_s=agg,
            check_s=round(phases.get("check", 0.0), 4),
            dispatches=int(counters.get("wgl.dispatches", 0)
                           + counters.get("mxu.dispatches", 0)),
            service_fallbacks=int(counters.get("service.fallback", 0)),
            service_shipped=int(counters.get("service.shipped", 0)),
            service_queue_wait_s=round(
                counters.get("service.queue_wait_s", 0.0), 6),
            engines={k[len("engine."):]: v for k, v in counters.items()
                     if k.startswith("engine.")},
            net=_row_net(counters),
            hists=hists, p=percentiles,
        )
        rows.append(row)
    return rows


def _expected_pass(workload: str) -> bool:
    from ..workloads import WORKLOADS_EXPECTED_TO_PASS
    return workload in WORKLOADS_EXPECTED_TO_PASS


def _tally_row(tel: Telemetry, row: dict) -> Optional[tuple]:
    """Count one finished row into the campaign telemetry; returns a
    failure tuple when the row should fail the campaign (the test-all
    exit-code contract: expected-to-pass workloads must pass; sweeps
    record skips and move on)."""
    status = row.get("status")
    tel.event("campaign.run", workload=row.get("workload"),
              nemesis=",".join(row.get("nemesis") or []),
              seed=row.get("seed"), status=status,
              valid=row.get("valid"), host=row.get("host"))
    if status == "skipped":
        tel.counter("campaign.skipped")
        return None
    if status == "error":
        tel.counter("campaign.errors")
        return (row.get("workload"), row.get("nemesis"),
                row.get("error"))
    tel.counter("campaign.completed")
    if row.get("valid") is not True and _expected_pass(row["workload"]):
        tel.counter("campaign.failed")
        return (row["workload"], row["nemesis"], row.get("valid"))
    return None


def run_campaign(specs: list[dict], *, pool: int = 4,
                 service: bool = True, service_tick_s: float = 0.05,
                 store_base: str = "store", name: str = "campaign",
                 start_method: str = "spawn",
                 live: bool = True,
                 hosts=None,
                 on_row=None) -> dict:
    """Run a campaign: every spec through the pool, one shared checker
    service (optional), one summary. ``pool=0`` runs specs inline in
    this process (the bench serial baseline). Returns the summary dict
    also written to ``<campaign dir>/campaign.json``.

    The campaign mints a trace id (``<name>-<dir id>``); each run gets
    ``<campaign trace>.r<index>`` stamped on every telemetry record,
    and the service carries ``<campaign trace>.svc`` — the artifacts
    join across processes by those ids. With ``live=True`` (default) a
    :class:`LiveCollector` aggregates the fleet's records into
    ``live.json`` for serve.py's ``/live`` page as the campaign runs.

    ``hosts`` switches the fan-out plane from a local process pool to
    the multi-host topology: an int spawns that
    many local worker-agent processes (named ``host1..hostN`` — CI's
    faked fleet over loopback TCP), a list of names does the same per
    name. The checker service then listens on TCP with a
    campaign-minted shared-secret token, every agent's runs ship their
    device checks to it cross-host (attributed per host by the
    JET-HOST preamble), and rows carry the host that ran them —
    ``service.host_submitted.<host>`` vs the rows' summed
    ``service_shipped`` is the cross-host ledger.

    Every spec's ``device`` is resolved first: with no card and a spec
    that asks for one, this raises before anything starts."""
    from ..device import resolve_device
    for dev in sorted({s["opts"].get("device") for s in specs}, key=str):
        resolve_device(dev)
    t0 = time.monotonic()
    cdir = make_store_dir(store_base, name)
    trace = f"{name}-{os.path.basename(cdir)}"
    tel = Telemetry(os.path.join(cdir, "telemetry.jsonl"), trace=trace)
    if isinstance(hosts, int):
        hosts = [f"host{i + 1}" for i in range(hosts)] if hosts else None
    # the fleet auth token: minted per campaign, shared with the
    # service and every spawned agent via env — never argv, never disk
    token = hashlib.sha256(
        f"{trace}-{os.getpid()}".encode()).hexdigest()[:16] \
        if hosts else None
    svc = None
    svc_tel = None
    collector = None
    agent_pool = None
    failures: list = []
    rows: list = [None] * len(specs)
    service_stats = None
    try:
        if live:
            try:
                collector = LiveCollector(cdir, trace=trace).start()
            except OSError:
                logger.warning("live collector unavailable; campaign "
                               "continues without /live", exc_info=True)
                collector = None
            if collector is not None:
                try:
                    # register as a live-polling candidate so serve's
                    # SSE tick stats this dir instead of listdir-ing
                    # the whole store
                    from .store_index import note_live
                    note_live(cdir)
                except Exception:
                    logger.debug("live index registration failed",
                                 exc_info=True)
        if service:
            from .checker_service import CheckerService
            # the service gets its own on-disk stream (service.jsonl in
            # the campaign dir): tick spans carry the contributing run
            # trace ids, which summaries don't preserve
            svc_tel = Telemetry(
                os.path.join(cdir, "service.jsonl"),
                trace=f"{trace}.svc", parent=trace,
                sink=None if collector is None else collector.path)
            # hosts mode raises the TCP listener too: agents are other
            # processes, so unix-socket reach is not enough — and the
            # token gates every cross-host frame
            svc = CheckerService(tick_s=service_tick_s, tel=svc_tel,
                                 tcp=bool(hosts),
                                 auth_token=token).start()
        run_specs = []
        for i, s in enumerate(specs):
            s = dict(s)
            s.setdefault("index", i)
            opts = dict(s["opts"])
            # runs store as siblings of the campaign dir (same base),
            # so the serve.py run index and rotation see them
            opts.setdefault("store_base", store_base)
            opts["trace_id"] = f"{trace}.r{s['index']}"
            opts["trace_parent"] = trace
            if collector is not None:
                opts["live_sink"] = collector.path
            if svc is not None:
                # agents are separate hosts (in CI: separate
                # processes), so they dial the TCP endpoint; the
                # single-host pool keeps the unix socket
                opts["checker_service"] = (svc.tcp_endpoint if hosts
                                           else svc.path)
                if token:
                    opts["checker_service_token"] = token
            s["opts"] = opts
            run_specs.append(s)
        tel.counter("campaign.runs", len(run_specs))
        # epoch-v2 specs the batched generator can serve leave the pool
        # entirely: grouped by (workload, nemesis) cell, each cell's
        # seeds generate in one lockstep columnar pass in THIS process,
        # then check/save per run. Everything else (live, unsupported
        # workload, stream/soak, epoch-v1) takes the pool as before.
        cells: dict = {}
        pooled = []
        if any(_batchable(s["opts"]) for s in run_specs):
            from ..simbatch import BatchConfig
        for s in run_specs:
            if _batchable(s["opts"]):
                # the full config identity, not just (workload,
                # nemesis): guided mutants perturb schedules/knobs
                # inside one matrix cell and must not be coalesced
                # into a neighbour's generate() call
                key = BatchConfig.from_opts(s["opts"]).cache_key()
                cells.setdefault(key, []).append(s)
            else:
                pooled.append(s)
        genbatch = {"cells": 0, "seeds": 0, "events": 0,
                    "ops_per_s": 0.0, "epoch": None}

        def _row_done(row: dict) -> None:
            rows[row["index"]] = row
            fail = _tally_row(tel, row)
            if fail is not None:
                failures.append(fail)
            if collector is not None:
                collector.note_row(row)
            if on_row is not None:
                on_row(row)

        with tel.span("campaign.sweep", runs=len(run_specs),
                      pool=pool, service=bool(svc)):
            for cell_specs in cells.values():
                for row in _run_batched_cell(cell_specs, tel, genbatch):
                    _row_done(row)
            run_specs = pooled
            if hosts:
                from .host_agent import HostAgentPool
                agent_pool = HostAgentPool(token=token, tel=tel).start()
                agent_pool.spawn_local(hosts)
                ready = agent_pool.wait_ready(len(hosts), timeout=120.0)
                tel.counter("campaign.hosts", ready)
                if ready < len(hosts):
                    logger.warning(
                        "only %d/%d agents registered; stragglers' "
                        "specs will run on the rest or inline",
                        ready, len(hosts))
                agent_pool.run(run_specs, _row_done)
            elif pool and pool > 0:
                import concurrent.futures as cf
                import multiprocessing as mp
                ctx = mp.get_context(start_method)
                with cf.ProcessPoolExecutor(max_workers=pool,
                                            mp_context=ctx) as ex:
                    futs = [ex.submit(_pool_run, s) for s in run_specs]
                    for fut in cf.as_completed(futs):
                        _row_done(fut.result())
            else:
                for s in run_specs:
                    _row_done(_pool_run(s))
        if svc is not None:
            service_stats = svc.stats()
    finally:
        if agent_pool is not None:
            agent_pool.close()
        if svc is not None:
            svc.close()
            if service_stats is not None:
                # only known post-join: stats() ran pre-close
                service_stats["shutdown_leaked_threads"] = \
                    svc.shutdown_leaked_threads
        if svc_tel is not None:
            # flush the service stream (counters + hists) to disk; the
            # campaign owns this recorder, not the service
            svc_tel.close()
    if service_stats is not None:
        # fold the service's counters (service.* coalescing accounting
        # AND the wgl./mxu. dispatch counters its device work accrued)
        # into the campaign telemetry: one file proves the
        # dispatches-per-(bucket, width, tick) bar
        for cname, value in (service_stats.get("counters") or {}).items():
            tel.counter(cname, value,
                        mode="max" if cname in ("service.batch_occupancy",
                                                "service.device_occupancy")
                        else "sum")
    if collector is not None:
        lstats = collector.close()
        tel.counter("live.records", lstats["records"])
        tel.counter("live.dropped", lstats["dropped"] + lstats["bad"])
    # campaign-wide distributions: every row's sparse histograms merge
    # bucket-wise (the Hist contract), giving fleet p50/p95/p99 per
    # group next to the per-row triples
    merged: dict = {}
    for row in rows:
        for label, d in ((row or {}).get("hists") or {}).items():
            merged.setdefault(label, Hist()).merge(Hist.from_dict(d))
    hist_summaries = {label: h.to_dict() for label, h in merged.items()}
    # per-host fold: which host ran what, and the cross-host ledger's
    # producer side — each host's summed service_shipped must equal
    # the service's service.host_submitted.<host> (consumer side)
    by_host: dict = {}
    for row in rows:
        h = (row or {}).get("host")
        if h is None:
            continue
        st = by_host.setdefault(h, {"runs": 0, "shipped": 0,
                                    "fallbacks": 0})
        st["runs"] += 1
        st["shipped"] += int(row.get("service_shipped") or 0)
        st["fallbacks"] += int(row.get("service_fallbacks") or 0)
    summary = {
        "name": name, "dir": cdir, "count": len(specs),
        "pool": pool,
        "trace": trace,
        "valid?": not failures,
        "failures": failures,
        "genbatch": genbatch if genbatch["cells"] else None,
        "runs": rows,
        "hists": hist_summaries,
        "p": {label: [d["p50"], d["p95"], d["p99"]]
              for label, d in hist_summaries.items()},
        "hosts": by_host or None,
        "agent_requeues": (agent_pool.requeues
                           if agent_pool is not None else 0),
        "wall_s": round(time.monotonic() - t0, 3),
        "service": None if service_stats is None else {
            "socket": svc.path, **service_stats},
        "telemetry": tel.summary(),
    }
    with open(os.path.join(cdir, "campaign.json"), "w") as f:
        json.dump(_scrub(summary), f, indent=2, default=repr)
    tel.close()
    try:
        # fold the campaign into the store index (and retire its live
        # row) now that campaign.json and service.jsonl are complete
        from .store_index import record_campaign
        record_campaign(cdir)
    except Exception:
        logger.debug("campaign index write failed", exc_info=True)
    link_latest(cdir)
    logger.info(
        "campaign %s: %d runs, %d failures, %.1f s (dir %s)",
        name, len(specs), len(failures), summary["wall_s"], cdir)
    return summary
