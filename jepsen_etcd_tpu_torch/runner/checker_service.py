"""The checker service: one process owns the card and checks every
run's packed histories (the port of the reference's
``runner/checker_service.py``).

A campaign runs many histories at once. If each run dispatched its own
device checks, each would pay at least one wave-kernel launch per
(bucket, width) group. Instead runner processes pack their histories
once (``ops/wgl.py`` ``serialize_packed``, ~32 B/op), ship them over a
socket, and the service coalesces everything pending across all
connections into one ``wgl.check_packed_batch`` call per group per tick:
one wave-kernel launch per (bucket, width) group per tick, however many
runs contributed keys.

Transports (``runner/transport.py``): a local AF_UNIX socket and TCP
(``tcp://HOST:PORT``). TCP connections open with a ``JET-HOST <name>``
preamble (per-host attribution) and authenticate with a shared-secret
token on a ``hello`` frame; both enforce the frame length cap before
allocating a byte.

Lanes: the service places each (bucket, width) group on a lane with a
sticky round-robin map (``DevicePlacement``; a group shape always lands
on the lane it first took) and hands the group's dispatch to that
lane's worker thread, which runs on a CUDA stream of its own. The lanes
are ``wgl_mxu.batch_lanes()``: every visible card (it raises without
one); tests and ``chip_smoke.py`` substitute it to run several lanes
on one device. A tick whose packs all share ONE group shape instead
splits that group over every lane (``check_packed_batch(shard=True)``:
the wave kernel one launch a lane, the ladder's keys split over the
lanes). Host packing is double-buffered: while tick N's jobs run on
their lanes, the dispatcher pads tick N+1's ladder tables
(``wgl.prepare_bucket_group``) for the keys the wave kernel cannot
take.

Soundness: the service runs the same ``check_packed_batch`` the runner
would, over deserialized packs (frame tables rebuilt bit-identically by
``ensure_frames``), and ships only the device verdicts back. Everything
judgment-shaped stays in the runner: keys the native DFS takes never
reach the socket, and the runner's ``_finalize`` runs its diagnostics,
overflow DFS and fallback ladder on the returned verdicts. A
``_resume`` payload (device tensors frozen mid-ladder) cannot cross the
socket; it is stripped and the runner re-runs the spill locally.

Degradation: a client failure on the transport (no socket, connect
refused, protocol error, auth reject, heartbeat silence) or an error
reply returns ``None`` from ``CheckerClient.check`` and bumps
``service.fallback``; the checker then runs the same packs in-process.
A kernel failure is not hidden by this: the service answers it with an
error reply, and the in-process re-run raises on the same fault.
Transport failures are not permanent: the client backs off under
capped exponential delay with jitter and re-probes when the cooldown
expires (``service.reconnects``).

Flow control: a ``check`` whose packs would overflow the bounded
pending queue, or whose connection has its in-flight quota out, is
answered at once with ``{"busy": true, "retry_after_s"}``
(``service.admission_rejects``); the client retries a bounded number
of times, then falls back. While a request is queued, the service
sends heartbeat frames on its connection, so a client tells a slow
tick from a dead service.

Wire format (length-prefixed frames, 8-byte little-endian size; TCP
adds the ``JET-HOST <name>\\n`` preamble before the first frame):

    request:  {"op": "check", "id": n, "sizes": [b0, b1, ...]}\\n
              <pack0 bytes><pack1 bytes>...
    response: {"id": n, "results": [...]}        (or {"id", "error"}
              or {"id", "busy": true, "retry_after_s": s})
    also:     {"op": "hello", "id": n, "token": t, "host": h}
              {"op": "ping"|"stats", "id": n} -> JSON-only responses
    async:    {"heartbeat": k, "pending": p}  (service -> any client
              with in-flight requests; not a reply, no id)
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import socket
import tempfile
import threading
import time
import zlib
from typing import Any, Optional

import torch

from ..device import lane_stream
from ..ops import wgl, wgl_mxu
from . import telemetry, transport
from .telemetry import Telemetry
from .transport import MAX_FRAME, FrameReader, send_frame as _send_frame

logger = logging.getLogger("jepsen_etcd_tpu_torch.checker_service")

#: env var naming the service endpoint (unix path or tcp://HOST:PORT);
#: opts/test["checker_service"] wins
ENV_VAR = "JEPSEN_ETCD_TPU_CHECKER_SERVICE"

#: env var carrying the shared-secret auth token;
#: opts/test["checker_service_token"] wins
ENV_TOKEN = "JEPSEN_ETCD_TPU_SERVICE_TOKEN"

#: env var naming this generator host for per-host attribution;
#: opts/test["host_id"] wins
ENV_HOST = "JEPSEN_ETCD_TPU_HOST"

#: client reconnect backoff: capped exponential with jitter. Module
#: level so tests can compress the clock.
RETRY_BASE_S = 0.25
RETRY_CAP_S = 30.0


def _plain(x: Any) -> Any:
    """JSON-safe copy of a verdict dict: numpy scalars and 0-d tensors
    to Python (``_resume`` payloads are stripped by callers)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    item = getattr(x, "item", None)
    if callable(item):
        return item()
    return repr(x)


class _Conn:
    """One client connection's server-side state. ``inflight`` is the
    admission-control ledger (requests queued or ticking, not yet
    answered) and the heartbeat trigger; mutated under the service
    ``_cv`` only."""

    __slots__ = ("sock", "wlock", "tcp", "host", "authed", "inflight")

    def __init__(self, sock, tcp=False):
        self.sock = sock
        self.wlock = threading.Lock()
        self.tcp = tcp
        self.host: Optional[str] = None
        self.authed = False
        self.inflight = 0


class _Request:
    """One pending check request: its packs, arrival time, the
    originating run's trace id, and the connection to answer on."""

    __slots__ = ("client", "req_id", "packs", "t_arrive", "trace")

    def __init__(self, client: _Conn, req_id, packs, t_arrive,
                 trace=None):
        self.client = client
        self.req_id = req_id
        self.packs = packs
        self.t_arrive = t_arrive
        self.trace = trace


def device_name(d=None) -> str:
    """``type+index`` of a device (``cuda0``, ``cpu0``), the attribution
    key the service carries on its per-lane counters. With no argument
    it names the process's default device: the current card, or
    ``cpu0`` without one."""
    if d is None:
        if not torch.cuda.is_available():
            return "cpu0"
        d = torch.device("cuda", torch.cuda.current_device())
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return f"{d.type}{d.index or 0}"


def lane_names(lanes: list) -> list:
    """One name per lane: its device's name, or ``<device>.<lane>`` when
    several lanes share a device."""
    names = [device_name(d) for d in lanes]
    if len(set(names)) < len(names):
        return [f"{n}.{i}" for i, n in enumerate(names)]
    return names


class DevicePlacement:
    """Sticky round-robin group→lane placement.

    The first time a (bucket, width) group shape appears it takes the
    next lane in round-robin order; every later tick reuses that lane.
    The lanes are ``wgl_mxu.batch_lanes()``, read on first use (it
    raises without a card unless substituted). All state lives under
    one lock: the service dispatcher, the stats reader, and the
    in-process fallback path (``fallback_device_for``) share instances.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._map: dict = {}
        self._lanes: Optional[list] = None
        self._next = 0

    def _ensure(self) -> list:
        # callers hold self._lock
        if self._lanes is None:
            self._lanes = list(wgl_mxu.batch_lanes())
        return self._lanes

    def devices(self) -> list:
        """Every lane's device (reads the lanes on first use)."""
        with self._lock:
            return list(self._ensure())

    def devices_if_known(self) -> list:
        """Like ``devices()`` but never reads the lanes: empty until
        some call did (safe from stats readers)."""
        with self._lock:
            return list(self._lanes or [])

    def assign(self, key) -> tuple:
        """(lane index, device) for a group key — sticky round-robin."""
        with self._lock:
            lanes = self._ensure()
            idx = self._map.get(key)
            if idx is None:
                idx = self._next % len(lanes)
                self._next += 1
                self._map[key] = idx
            return idx, lanes[idx]

    def snapshot(self) -> dict:
        """JSON-safe ``repr(group_key) -> lane name`` map."""
        with self._lock:
            names = lane_names(self._lanes or [])
            return {repr(k): names[i] for k, i in self._map.items()}


#: per-process sticky placement for in-process fallbacks — the same
#: group→lane policy the service dispatcher runs
_process_placement: Optional[DevicePlacement] = None
_process_placement_lock = threading.Lock()


def process_placement() -> DevicePlacement:
    global _process_placement
    with _process_placement_lock:
        if _process_placement is None:
            _process_placement = DevicePlacement()
        return _process_placement


def fallback_device_for(tel: Optional[Telemetry] = None):
    """A ``group_key -> device`` callback for
    ``wgl.check_packed_batch(device_for=...)``: routes a service-down
    fallback through the process's sticky placement map and counts
    each placed group under ``service.fallback.<lane>``. None when
    fewer than two lanes are visible (placement is a no-op there)."""
    place = process_placement()
    lanes = place.devices()
    if len(lanes) < 2:
        return None
    names = lane_names(lanes)

    def device_for(key):
        idx, dev = place.assign(key)
        if tel is not None:
            tel.counter("service.fallback." + names[idx])
        return dev

    return device_for


class _GroupJob:
    """One group's dispatch, run on a lane's worker thread. The job
    owns all its state — the worker only calls ``run()`` and the
    dispatcher only reads after ``done`` is set."""

    __slots__ = ("packs", "key", "device", "dev_names", "shard",
                 "prepared", "outs", "error", "busy_s", "launches",
                 "done")

    def __init__(self, packs, key, device, dev_names, shard, prepared):
        self.packs = packs
        self.key = key
        self.device = device
        self.dev_names = dev_names
        self.shard = shard
        self.prepared = prepared
        self.outs = None
        self.error = None
        self.busy_s = 0.0
        self.launches = 0
        self.done = threading.Event()

    def run(self) -> None:
        t0 = time.monotonic()
        n0 = wgl_mxu.thread_launches()
        try:
            prepared = ({self.key: self.prepared}
                        if self.prepared is not None else None)
            # module-attribute lookup at call time: tests monkeypatch
            # wgl.check_packed_batch and the jobs must see it
            self.outs = wgl.check_packed_batch(
                self.packs, device=self.device, shard=self.shard,
                prepared=prepared)
        except Exception as e:  # answer the error, never wedge clients
            logger.exception("checker service group dispatch failed")
            self.error = repr(e)
        finally:
            self.launches = wgl_mxu.thread_launches() - n0
            self.busy_s = time.monotonic() - t0
            self.done.set()


def _ladder_tables(gpacks: list, key: tuple, device, lanes: int):
    """A group's batched-rung tables, padded ahead on the dispatcher
    thread (``wgl.prepare_bucket_group``) for the keys the rung will
    take: on the card the wave kernel goes first, so only the keys it
    cannot take (a key it overflows is rebuilt at dispatch). None when
    no such key is left, or one alone on one lane (it climbs the
    ladder instead)."""
    local = list(range(len(gpacks)))
    if wgl._b1_first(device):
        local = [i for i in local if not wgl_mxu.supported(gpacks[i])]
    if not local or (lanes == 1 and len(local) == 1):
        return None
    return wgl.prepare_bucket_group(gpacks, local, key[0], key[1],
                                    lanes=lanes)


class _Tick:
    """One in-flight coalescing tick: its request batch, flattened
    pack slots, per-pack results, and the group jobs out on the lanes'
    worker queues. Exists so the dispatcher can hold tick N open (jobs
    running on their lanes) while it packs tick N+1."""

    __slots__ = ("batch", "slots", "results", "jobs", "trivial_err",
                 "t_start", "span", "n_packs", "n_groups", "sharded",
                 "pack_s")


class CheckerService:
    """The device-owning batch scheduler.

    Threads: one acceptor per listener (unix always, TCP when
    enabled), one reader per connection (they only parse, admit, and
    enqueue), ONE dispatcher that freezes batches, packs host tables,
    and places groups, one worker per lane that runs the placed group
    dispatches (``_GroupJob.run``) on the lane's own stream, and one
    heartbeat sender. All shared service state (pending queue,
    admission ledgers, connection list, worker queues, stop flag) is
    mutated under ``_cv`` only; job state is handed off through the
    per-job ``done`` event, and the placement map has its own lock.
    ``start()`` reads the lanes, so it raises without a card unless
    ``wgl_mxu.batch_lanes`` is substituted.
    """

    def __init__(self, path: Optional[str] = None,
                 tick_s: float = 0.05,
                 tel: Optional[Telemetry] = None,
                 tcp=None,
                 auth_token: Optional[str] = None,
                 max_pending_packs: int = 512,
                 max_inflight_per_conn: int = 8,
                 heartbeat_s: float = 1.0,
                 max_frame: int = MAX_FRAME,
                 shutdown_join_s: float = 30.0):
        if path is None:
            path = os.path.join(
                tempfile.mkdtemp(prefix="jet-checker-"), "checker.sock")
        self.path = path
        self.tick_s = tick_s
        self.tel = tel if tel is not None else Telemetry()
        #: TCP listen spec: None/False -> unix only; True -> loopback
        #: ephemeral port; int port or "HOST:PORT" -> explicit bind
        self.tcp = tcp
        self.tcp_endpoint: Optional[str] = None
        self.auth_token = (auth_token if auth_token is not None
                           else os.environ.get(ENV_TOKEN) or None)
        self.max_pending_packs = max_pending_packs
        self.max_inflight_per_conn = max_inflight_per_conn
        self.heartbeat_s = heartbeat_s
        self.max_frame = max_frame
        self.shutdown_join_s = shutdown_join_s
        #: threads still alive after close() gave up joining them —
        #: surfaced in stats() and the service.shutdown_leaked_threads
        #: counter so a wedged worker is a ledger entry, not a mystery
        self.shutdown_leaked_threads = 0
        self._cv = threading.Condition()
        self._pending: list[_Request] = []
        self._pending_packs = 0  # admission ledger: queued + ticking
        self._conns: list[_Conn] = []
        self._threads: list[threading.Thread] = []
        self._stopped = False
        self._listener: Optional[socket.socket] = None
        self._tcp_listener: Optional[socket.socket] = None
        self._placement = DevicePlacement()
        self._work_qs: list[queue.Queue] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "CheckerService":
        lanes = self._placement.devices()
        ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(self.path)
        except OSError:
            pass
        ls.bind(self.path)
        ls.listen(64)
        # closing a listener does NOT wake a blocked accept() on
        # Linux; poll with a short timeout so close() never hangs
        ls.settimeout(0.25)
        ts = None
        if self.tcp:
            ts, self.tcp_endpoint = transport.listen_tcp(self.tcp)
            ts.settimeout(0.25)
        qs = [queue.Queue() for _ in lanes]
        with self._cv:
            self._listener = ls
            self._tcp_listener = ts
            self._work_qs = qs
            threads = [
                threading.Thread(
                    target=self._accept_loop, args=(ls, False),
                    name="checker-svc-accept", daemon=True),
                threading.Thread(
                    target=self._dispatch_loop,
                    name="checker-svc-dispatch", daemon=True),
                threading.Thread(
                    target=self._heartbeat_loop,
                    name="checker-svc-heartbeat", daemon=True),
            ] + [threading.Thread(target=self._lane_worker,
                                  args=(q, dev),
                                  name=f"checker-svc-lane{i}",
                                  daemon=True)
                 for i, (q, dev) in enumerate(zip(qs, lanes))]
            if ts is not None:
                threads.append(threading.Thread(
                    target=self._accept_loop, args=(ts, True),
                    name="checker-svc-accept-tcp", daemon=True))
            self._threads += threads
        for t in threads:
            t.start()
        logger.info("checker service listening on %s%s over %d lane(s)",
                    self.path, f" and {self.tcp_endpoint}"
                    if ts is not None else "", len(lanes))
        return self

    def close(self) -> None:
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            self._cv.notify_all()
            listeners = [self._listener, self._tcp_listener]
            conns = list(self._conns)
            threads = list(self._threads)
        for ls in listeners:
            if ls is not None:
                try:
                    ls.close()
                except OSError:
                    pass
        for c in conns:
            # shutdown (not just close) reliably wakes a reader
            # blocked in recv() on this connection
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=self.shutdown_join_s)
        leaked = [t.name for t in threads if t.is_alive()]
        if leaked:
            logger.warning(
                "checker service shutdown leaked %d thread(s): %s",
                len(leaked), ", ".join(sorted(leaked)))
            self.tel.counter("service.shutdown_leaked_threads",
                             len(leaked))
        self.shutdown_leaked_threads = len(leaked)
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def stats(self) -> dict:
        """The service's telemetry summary (counters + spans) plus the
        lane roster, sticky placement map, and transport endpoints."""
        out = self.tel.summary()
        out["devices"] = lane_names(self._placement.devices_if_known())
        out["placement"] = self._placement.snapshot()
        out["endpoint"] = self.path
        out["tcp_endpoint"] = self.tcp_endpoint
        out["shutdown_leaked_threads"] = self.shutdown_leaked_threads
        return out

    # -- socket side ---------------------------------------------------------
    def _accept_loop(self, ls: socket.socket, tcp: bool) -> None:
        while True:
            with self._cv:
                if self._stopped:
                    return
            try:
                conn, _ = ls.accept()
            except socket.timeout:
                continue  # poll the stop flag
            except OSError:
                return  # listener closed by close()
            cstate = _Conn(conn, tcp=tcp)
            reader = threading.Thread(
                target=self._reader, args=(cstate,),
                name="checker-svc-reader", daemon=True)
            with self._cv:
                if self._stopped:
                    conn.close()
                    return
                self._conns.append(cstate)
                self._threads.append(reader)
            reader.start()

    def _reader(self, cstate: _Conn) -> None:
        try:
            reader = FrameReader(cstate.sock, max_frame=self.max_frame)
            if cstate.tcp:
                # TCP opens with "JET-HOST <name>\n"; absent (a bare
                # frame) the connection is simply anonymous
                host = reader.read_preamble()
                if host:
                    with self._cv:
                        cstate.host = host
            while True:
                frame = reader.recv_frame()
                if frame is None:
                    return
                self._handle(cstate, frame)
        except (OSError, ValueError) as e:
            logger.debug("checker service reader exits: %r", e)
        finally:
            with self._cv:
                if cstate in self._conns:
                    self._conns.remove(cstate)
            try:
                cstate.sock.close()
            except OSError:
                pass

    def _reply(self, cstate: _Conn, payload: dict) -> None:
        with cstate.wlock:
            _send_frame(cstate.sock, json.dumps(payload).encode())

    def _handle(self, cstate: _Conn, frame: bytes) -> None:
        nl = frame.index(b"\n") if b"\n" in frame else len(frame)
        head = json.loads(frame[:nl].decode())
        op = head.get("op")
        rid = head.get("id")
        if op == "hello":
            if self.auth_token and head.get("token") != self.auth_token:
                self.tel.counter("service.auth_rejects")
                self._reply(cstate, {"id": rid,
                                     "error": "bad auth token"})
                raise ValueError("auth token rejected")
            with self._cv:
                cstate.authed = True
                if head.get("host"):
                    cstate.host = head["host"]
            self._reply(cstate, {"id": rid, "ok": True})
            return
        if op == "ping":
            self._reply(cstate, {"id": rid, "ok": True})
            return
        if self.auth_token and not cstate.authed:
            # ping stays open as an unauthenticated liveness probe;
            # everything that reads or submits state requires hello
            self.tel.counter("service.auth_rejects")
            self._reply(cstate, {"id": rid, "error": "auth required"})
            raise ValueError("unauthenticated request")
        if op == "stats":
            self._reply(cstate, {"id": rid, "stats": self.stats()})
            return
        if op != "check":
            self._reply(cstate, {"id": rid,
                                 "error": f"unknown op {op!r}"})
            return
        sizes = head["sizes"]
        n = len(sizes)
        # admission BEFORE deserialization: an over-capacity request
        # costs a JSON head parse and one small reply, never a pack
        # decode or an unbounded queue slot
        with self._cv:
            over = (cstate.inflight >= self.max_inflight_per_conn
                    or self._pending_packs + n > self.max_pending_packs)
            if not over:
                cstate.inflight += 1
                self._pending_packs += n
        if over:
            self.tel.counter("service.admission_rejects")
            self._reply(cstate, {
                "id": rid, "busy": True,
                "retry_after_s": round(max(2 * self.tick_s, 0.05), 3)})
            return
        try:
            packs = []
            off = nl + 1
            for size in sizes:
                packs.append(
                    wgl.deserialize_packed(frame[off:off + size]))
                off += size
        except Exception as e:
            # a malformed pack (wrong wire version, torn blob) degrades
            # THIS request, not the connection: refund the admission
            # slots and answer with a structured error
            with self._cv:
                cstate.inflight -= 1
                self._pending_packs -= n
            self.tel.counter("service.bad_requests")
            logger.warning("checker service rejected request: %r", e)
            self._reply(cstate, {"id": rid, "error": repr(e)})
            return
        req = _Request(cstate, rid, packs, time.monotonic(),
                       trace=head.get("trace"))
        self.tel.counter("service.requests")
        self.tel.counter("service.submitted", len(packs))
        if cstate.host:
            self.tel.counter("service.host_submitted." + cstate.host,
                             len(packs))
        with self._cv:
            self._pending.append(req)
            self._cv.notify_all()

    def _heartbeat_loop(self) -> None:
        """Beat every connection with in-flight requests once per
        interval: silence longer than a client's idle timeout means the
        service is dead, not slow."""
        seq = 0
        while True:
            with self._cv:
                if self._stopped:
                    return
                self._cv.wait(timeout=self.heartbeat_s)
                if self._stopped:
                    return
                targets = [c for c in self._conns if c.inflight > 0]
                pending = self._pending_packs
            if not targets:
                continue
            seq += 1
            payload = json.dumps({"heartbeat": seq,
                                  "pending": pending}).encode()
            sent = 0
            for c in targets:
                try:
                    with c.wlock:
                        _send_frame(c.sock, payload)
                    sent += 1
                except OSError:
                    continue  # reader notices the dead conn
            if sent:
                self.tel.counter("service.heartbeats_sent", sent)

    # -- device side ---------------------------------------------------------
    def _dispatch_loop(self) -> None:
        # deep code reaches the recorder via telemetry.current(); the
        # thread-local pin cannot race with other threads
        telemetry.set_thread_current(self.tel)
        inflight: Optional[_Tick] = None
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._pending:
                    break
            # coalescing window: let concurrently-finishing runs land
            # their submissions before the batch is frozen
            time.sleep(self.tick_s)
            with self._cv:
                batch, self._pending = self._pending, []
            if not batch:
                if inflight is not None:
                    self._finalize_tick(inflight)
                    inflight = None
                continue
            # double buffer: pack tick N+1's host tables WHILE tick
            # N's jobs are still running on their lanes
            tick = self._prepare_tick(batch)
            if inflight is not None:
                self._finalize_tick(inflight)
                inflight = None
            self._submit_tick(tick)
            with self._cv:
                more = bool(self._pending) and not self._stopped
            if more:
                inflight = tick  # keep packing; finalize next loop
            else:
                self._finalize_tick(tick)  # idle: reply promptly
        if inflight is not None:
            self._finalize_tick(inflight)
        with self._cv:
            qs = list(self._work_qs)
        for q in qs:
            q.put(None)  # worker shutdown sentinels

    def _lane_worker(self, q: queue.Queue, dev: torch.device) -> None:
        """Run one lane's jobs, in order, on a CUDA stream of its own
        (the card's default stream is never used)."""
        telemetry.set_thread_current(self.tel)
        with lane_stream(dev):
            while True:
                job = q.get()
                if job is None:
                    return
                job.run()

    def _prepare_tick(self, batch: list[_Request]) -> _Tick:
        """The host half of a tick: flatten the batch, answer trivial
        packs inline, group the rest, place each group on its sticky
        lane, and pad the host tables (the work that overlaps the
        previous tick's device wall)."""
        tick = _Tick()
        tick.batch = batch
        tick.t_start = time.monotonic()
        tick.span = None
        tick.trivial_err = None
        all_packs = []
        slots = []  # (request index, offset into its results)
        for ri, req in enumerate(batch):
            for j, p in enumerate(req.packs):
                all_packs.append(p)
                slots.append((ri, j))
        tick.slots = slots
        tick.n_packs = len(all_packs)
        tick.results = [None] * len(all_packs)
        groups: dict = {}
        trivial = []
        for i, p in enumerate(all_packs):
            if p.ok and p.R > 0:
                groups.setdefault(wgl.group_key(p), []).append(i)
            else:
                trivial.append(i)
        tick.n_groups = len(groups)
        if trivial:
            # degenerate packs (rejected windows, zero reads) never
            # touch a device; answer them on the dispatcher thread
            try:
                for i, out in zip(trivial, wgl.check_packed_batch(
                        [all_packs[i] for i in trivial])):
                    tick.results[i] = out
            except Exception as e:
                logger.exception("checker service trivial check failed")
                tick.trivial_err = repr(e)
        lanes = self._placement.devices()
        names = lane_names(lanes)
        # one group and several lanes: split that group over every
        # lane instead of parking all but one (the key axis pads to the
        # lane count, so even a lone pack spreads)
        tick.sharded = len(groups) == 1 and len(lanes) > 1
        tick.jobs = []
        for key, idxs in groups.items():
            gpacks = [all_packs[i] for i in idxs]
            if tick.sharded:
                prep = _ladder_tables(gpacks, key, None, len(lanes))
                job = _GroupJob(gpacks, key, None, names, True, prep)
                qi = 0
            else:
                qi, dev = self._placement.assign(key)
                prep = _ladder_tables(gpacks, key, dev, 1)
                job = _GroupJob(gpacks, key, dev, [names[qi]], False,
                                prep)
            tick.jobs.append((job, idxs, qi))
        tick.pack_s = time.monotonic() - tick.t_start
        return tick

    def _submit_tick(self, tick: _Tick) -> None:
        """Open the tick span and hand every group job to its lane's
        worker queue (each lane's dispatches stay serialized on its own
        worker)."""
        runs = sorted({req.trace for req in tick.batch
                       if req.trace is not None})
        hosts = sorted({req.client.host for req in tick.batch
                        if req.client.host is not None})
        dev_names = sorted({nm for job, _i, _q in tick.jobs
                            for nm in job.dev_names})
        dev_attr = (dev_names[0] if len(dev_names) == 1
                    else f"{len(dev_names)} devices" if dev_names
                    else device_name())
        tick.span = self.tel.span(
            "service.tick", packs=tick.n_packs,
            requests=len(tick.batch), groups=tick.n_groups,
            runs=runs, hosts=hosts, device=dev_attr,
            sharded=bool(tick.sharded))
        tick.span.__enter__()
        with self._cv:
            qs = list(self._work_qs)
        for job, _idxs, qi in tick.jobs:
            qs[qi % len(qs)].put(job)

    def _finalize_tick(self, tick: _Tick) -> None:
        """Join the tick's jobs, fold their telemetry (the per-lane
        ledger), and answer every request."""
        errors = []
        if tick.trivial_err:
            errors.append(tick.trivial_err)
        busy_by_dev: dict[str, float] = {}
        dispatches: dict[str, int] = {}
        launches = 0
        for job, idxs, _qi in tick.jobs:
            job.done.wait(timeout=600)
            if not job.done.is_set():
                errors.append(f"group {job.key!r} dispatch timed out")
                continue
            if job.error is not None:
                errors.append(job.error)
            elif job.outs is not None:
                for i, out in zip(idxs, job.outs):
                    tick.results[i] = out
            launches += job.launches
            # fan-counted: a sharded job burns EVERY lane for its
            # wall, a placed job exactly one
            for nm in job.dev_names:
                busy_by_dev[nm] = busy_by_dev.get(nm, 0.0) + job.busy_s
                dispatches[nm] = dispatches.get(nm, 0) + 1
        err = "; ".join(errors) if errors else None
        tick.span.set(error=err, placement=dict(dispatches),
                      wgl_wave_launches=launches)
        tick.span.__exit__(None, None, None)
        # per-lane ledger: every group this tick dispatched exactly
        # once, plus one extra lane-dispatch per extra lane of the
        # sharded job
        fanout = sum(len(job.dev_names) - 1
                     for job, _i, _q in tick.jobs)
        placed = sum(dispatches.values())
        assert placed == len(tick.jobs) + fanout, \
            (placed, len(tick.jobs), fanout)
        self.tel.counter("service.ticks")
        self.tel.counter("service.group_ticks", tick.n_groups)
        # packs in minus one dispatch per group IS the number of device
        # calls coalescing saved
        self.tel.counter("service.coalesced",
                         tick.n_packs - tick.n_groups)
        self.tel.counter("service.batch_occupancy", tick.n_packs,
                         mode="max")
        self.tel.counter("service.pack_s", round(tick.pack_s, 6))
        # the wave kernel's launches, counted by each job on its own
        # thread (the process-wide wgl_mxu.LAUNCHES mixes callers)
        self.tel.counter("service.wgl_wave_launches", launches)
        for nm in sorted(dispatches):
            self.tel.counter("service.device_dispatches." + nm,
                             dispatches[nm])
            self.tel.counter("service.device_busy_s." + nm,
                             round(busy_by_dev[nm], 6))
        if dispatches:
            self.tel.counter("service.device_occupancy",
                             len(dispatches), mode="max")
        if tick.sharded:
            self.tel.counter("service.sharded_ticks")
            self.tel.counter("service.shard_fanout", fanout)
        # each request's wait is rounded ONCE and used everywhere — the
        # summed counter, the hist, and the per-request reply
        waits = [round(tick.t_start - req.t_arrive, 6)
                 for req in tick.batch]
        self.tel.counter("service.queue_wait_s", round(sum(waits), 6))
        for w in waits:
            self.tel.hist("service.queue_wait_s", w)
        results_by_req: dict[int, list] = {
            ri: [None] * len(req.packs)
            for ri, req in enumerate(tick.batch)}
        if err is None:
            for (ri, j), out in zip(tick.slots, tick.results):
                out = dict(out)
                # frozen-frontier device tensors cannot cross the
                # socket; the runner's overflow path re-runs the spill
                # locally
                out.pop("_resume", None)
                results_by_req[ri][j] = _plain(out)
        for ri, req in enumerate(tick.batch):
            if err is not None:
                payload = {"id": req.req_id, "error": err,
                           "queue_wait_s": waits[ri]}
            else:
                payload = {"id": req.req_id,
                           "results": results_by_req[ri],
                           "queue_wait_s": waits[ri]}
            try:
                self._reply(req.client, payload)
            except OSError:
                logger.debug("checker service: client went away")
            finally:
                # refund the admission slots whether or not the client
                # lived to hear the answer — the ledger must drain
                with self._cv:
                    req.client.inflight -= 1
                    self._pending_packs -= len(req.packs)


# ---------------------------------------------------------------------------
# client side (runs inside runner processes)


class ServiceUnavailable(Exception):
    pass


class CheckerClient:
    """Synchronous client: one request outstanding at a time (the
    checker blocks on its verdicts anyway).

    Failures are never permanent. A transport failure closes the
    socket and arms a cooldown (capped exponential backoff + jitter);
    calls during the cooldown raise :class:`ServiceUnavailable`
    immediately (the caller falls back in-process for THAT call), and
    the first call after it expires re-connects — counting
    ``service.reconnects`` when it succeeds. While waiting for a
    verdict the client only tolerates ``idle_timeout`` seconds of
    SILENCE: the service heartbeats queued connections every second, so
    silence means dead, not slow; ``timeout`` is the overall ceiling.
    """

    def __init__(self, endpoint: str, timeout: float = 600.0,
                 token: Optional[str] = None,
                 host: Optional[str] = None,
                 connect_timeout: float = 5.0,
                 idle_timeout: float = 20.0,
                 max_busy_retries: int = 4):
        self.endpoint = endpoint
        self.timeout = timeout
        self.token = (token if token is not None
                      else os.environ.get(ENV_TOKEN) or None)
        if host is None and transport.is_tcp(endpoint):
            host = (os.environ.get(ENV_HOST)
                    or socket.gethostname() or "client")
        self.host = host
        self.connect_timeout = connect_timeout
        self.idle_timeout = idle_timeout
        self.max_busy_retries = max_busy_retries
        # reentrant: the helpers re-take it around their own state
        # writes even though _rpc already holds it
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[FrameReader] = None
        self._next_id = 0
        self._fails = 0
        self._retry_at = 0.0
        # deterministic jitter per endpoint: no two clients of one
        # campaign re-probe a healing service in lockstep
        self._rng = random.Random(zlib.crc32(endpoint.encode()))
        #: queue wait the service attributed to the LAST check() reply
        #: (seconds); None until a reply carries one
        self.last_queue_wait_s: Optional[float] = None

    # -- health --------------------------------------------------------------
    @property
    def broken(self) -> bool:
        """True while the reconnect cooldown is armed."""
        return self._fails > 0 and time.monotonic() < self._retry_at

    def available(self) -> bool:
        return not self.broken

    @property
    def connected(self) -> bool:
        return self._sock is not None

    @property
    def fails(self) -> int:
        return self._fails

    # -- transport -----------------------------------------------------------
    def _mark_failed_locked(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                self._reader = None
            self._fails += 1
            delay = min(RETRY_CAP_S,
                        RETRY_BASE_S * (2 ** min(self._fails - 1, 16)))
            delay *= 0.5 + self._rng.random()  # jitter in [0.5x, 1.5x)
            self._retry_at = time.monotonic() + delay

    def _exchange_locked(self, head: dict, body: bytes = b"") -> dict:
        head = dict(head)
        with self._lock:
            head["id"] = self._next_id
            self._next_id += 1
        _send_frame(self._sock, json.dumps(head).encode() + b"\n"
                    + body)
        deadline = time.monotonic() + self.timeout
        while True:
            # FrameReader is re-entrant across socket timeouts, but an
            # idle timeout here means NO bytes — not even a heartbeat
            # — for idle_timeout seconds: the service is dead or cut
            frame = self._reader.recv_frame()
            if frame is None:
                raise ConnectionError("connection closed by service")
            resp = json.loads(frame.decode())
            if "heartbeat" in resp:
                telemetry.current().counter("service.heartbeats_seen")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no reply within timeout={self.timeout}s "
                        "(service alive but stuck)")
                continue
            if resp.get("id") != head["id"]:
                continue  # stale reply from an abandoned exchange
            return resp

    def _connect_locked(self) -> None:
        if self._sock is not None:
            return
        s = transport.connect(self.endpoint,
                              timeout=self.connect_timeout)
        s.settimeout(self.idle_timeout)
        if transport.is_tcp(self.endpoint):
            transport.send_preamble(s, self.host or "client")
        with self._lock:
            self._sock = s
            self._reader = FrameReader(s)
        hello = {"op": "hello"}
        if self.token is not None:
            hello["token"] = self.token
        if self.host is not None:
            hello["host"] = self.host
        resp = self._exchange_locked(hello)
        if resp.get("error"):
            raise ConnectionError(f"hello rejected: {resp['error']}")
        with self._lock:
            if self._fails:
                telemetry.current().counter("service.reconnects")
            self._fails = 0
            self._retry_at = 0.0

    def _rpc(self, head: dict, body: bytes = b"") -> dict:
        with self._lock:
            now = time.monotonic()
            if self._fails and now < self._retry_at:
                raise ServiceUnavailable(
                    f"{self.endpoint}: cooling down "
                    f"{self._retry_at - now:.2f}s after "
                    f"{self._fails} failure(s)")
            try:
                self._connect_locked()
                return self._exchange_locked(head, body)
            except (OSError, ValueError) as e:
                # OSError covers sockets and timeouts; ValueError torn
                # frames, oversized frames and undecodable JSON
                self._mark_failed_locked()
                raise ServiceUnavailable(repr(e)) from e

    # -- API -----------------------------------------------------------------
    def ping(self) -> bool:
        try:
            return bool(self._rpc({"op": "ping"}).get("ok"))
        except ServiceUnavailable:
            return False

    def stats(self) -> Optional[dict]:
        try:
            return self._rpc({"op": "stats"}).get("stats")
        except ServiceUnavailable:
            return None

    def check(self, packs: list,
              trace: Optional[str] = None) -> Optional[list]:
        """Ship packed histories; returns one verdict dict per pack
        (aligned), or None if the service failed or stayed saturated —
        callers MUST then check the same packs in-process. ``trace`` is
        the originating run's trace id, stamped on the tick span. A BUSY
        reply (admission control) is retried under a short bounded
        backoff — the transport is healthy, so it never arms the
        reconnect cooldown."""
        blobs = [wgl.serialize_packed(p) for p in packs]
        head = {"op": "check", "sizes": [len(b) for b in blobs]}
        if trace is not None:
            head["trace"] = trace
        body = b"".join(blobs)
        for attempt in range(self.max_busy_retries + 1):
            try:
                resp = self._rpc(head, body)
            except ServiceUnavailable:
                return None
            if resp.get("busy"):
                telemetry.current().counter("service.busy_retries")
                if attempt == self.max_busy_retries:
                    return None  # saturated: fall back in-process
                wait = float(resp.get("retry_after_s") or 0.05)
                time.sleep(min(wait * (attempt + 1), 2.0))
                continue
            break
        with self._lock:
            self.last_queue_wait_s = resp.get("queue_wait_s")
        results = resp.get("results")
        if results is None or len(results) != len(packs):
            # an error reply (a failed tick): the transport is healthy,
            # so no cooldown — this call falls back in-process
            if resp.get("error"):
                logger.warning("checker service error reply: %s",
                               resp["error"])
            return None
        return results

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                self._reader = None


#: per-process client cache. Entries are kept across failures — the
#: client's own backoff cooldown IS the negative cache, and it
#: expires, so a healed service gets re-probed.
_clients: dict[str, CheckerClient] = {}
_clients_lock = threading.Lock()


def endpoint_for(test: Any) -> Optional[str]:
    """The configured service endpoint (unix path or tcp://HOST:PORT)
    for a test dict (or env), if any."""
    ep = None
    if isinstance(test, dict):
        ep = test.get("checker_service")
    return ep or os.environ.get(ENV_VAR) or None


def token_for(test: Any) -> Optional[str]:
    tok = None
    if isinstance(test, dict):
        tok = test.get("checker_service_token")
    return tok or os.environ.get(ENV_TOKEN) or None


def host_for(test: Any) -> Optional[str]:
    host = None
    if isinstance(test, dict):
        host = test.get("host_id")
    return host or os.environ.get(ENV_HOST) or None


def client_for(test: Any) -> Optional[CheckerClient]:
    """A working (cached) client for the test's service endpoint, or
    None — absent config, failed connect, or a client inside its
    reconnect cooldown all mean "check in-process THIS call". A dead
    endpoint is re-probed once per backoff window, so a service that
    comes up mid-campaign is adopted automatically."""
    endpoint = endpoint_for(test)
    if not endpoint:
        return None
    with _clients_lock:
        client = _clients.get(endpoint)
        if client is None:
            client = CheckerClient(endpoint, token=token_for(test),
                                   host=host_for(test))
            _clients[endpoint] = client
    if client.connected:
        return client
    if not client.available():
        return None  # cooling down; the entry expires on its own
    if client.ping():
        return client
    log = logger.warning if client.fails == 1 else logger.debug
    log("checker service unreachable at %s; checking in-process "
        "(retry in <=%.1fs)", endpoint,
        max(0.0, client._retry_at - time.monotonic()))
    return None


def reset_clients() -> None:
    """Drop the per-process client cache (tests)."""
    with _clients_lock:
        for c in _clients.values():
            c.close()
        _clients.clear()
