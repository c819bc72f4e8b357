"""Worker host agents: fan campaign runs across processes over TCP.

The fleet inverts the control-node shape of jepsen — many
generator hosts feeding one checking service that owns the card. This
module is the generator-host half: the campaign process raises a
:class:`HostAgentPool` (a loopback TCP registrar), spawns one
``worker-agent`` process per simulated host (``python -m
jepsen_etcd_tpu_torch worker-agent --connect tcp://... --host hostB``),
and drives specs at whichever agents are registered. Each agent runs the
same ``campaign._pool_run`` a ProcessPoolExecutor worker would, but
over the wire: it announces itself with the ``JET-HOST`` preamble,
authenticates with the campaign's shared-secret token, stamps every
row with its host name, and heartbeats while a run is in flight so the
campaign can tell slow from dead.

Fault posture mirrors the checker client: a dead or torn agent
connection re-queues the spec (``campaign.agent_requeues``) for the
surviving agents, with a requeue cap so a poisonous spec cannot
ping-pong forever — past the cap (and for any specs stranded when
every agent has died) the campaign runs the spec inline itself, so a
campaign always completes.

Transport framing is ``runner/transport.py``; pool<->agent frames are
pure JSON (specs and summary rows — packed histories never cross this
link; those go agent -> checker service directly). Wall-clock here is
process supervision and socket I/O, never verdict input; every shared
attribute a worker thread touches is written under ``self._cv``.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import threading
from collections import deque
from typing import Optional

from . import telemetry
from .checker_service import ENV_HOST, ENV_TOKEN
from .transport import FrameReader, connect, listen_tcp, send_frame, \
    send_preamble

logger = logging.getLogger("jepsen_etcd_tpu_torch.host_agent")

#: how many times a spec may be re-queued after agent deaths before
#: the campaign gives up on the fleet and runs it inline
REQUEUE_CAP = 2

#: agent-side heartbeat cadence while connected (seconds); the pool's
#: idle timeout must comfortably exceed this
BEAT_S = 1.0

#: pool-side max silence from an agent before it is declared dead
#: (>> BEAT_S: heartbeats keep a healthy-but-slow run alive)
IDLE_TIMEOUT_S = 20.0


#: the directory holding this package, put on the agents' PYTHONPATH
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def agent_argv(endpoint: str, host: str) -> list:
    """The command line of one spawned worker agent: this package's
    ``worker-agent`` command."""
    return [sys.executable, "-m", "jepsen_etcd_tpu_torch", "worker-agent",
            "--connect", endpoint, "--host", host]


def _jframe(sock: socket.socket, wlock, obj: dict) -> None:
    """Send one JSON object as a frame, serialized under the writer
    lock (the beat thread and the run loop share the socket)."""
    data = json.dumps(obj, default=repr).encode()
    with wlock:
        send_frame(sock, data)


class _Agent:
    """Pool-side state for one registered worker agent."""

    __slots__ = ("sock", "reader", "host", "wlock")

    def __init__(self, sock: socket.socket, reader: FrameReader,
                 host: str):
        self.sock = sock
        self.reader = reader
        self.host = host
        self.wlock = threading.Lock()


class HostAgentPool:
    """The campaign's agent registrar + dispatcher.

    ``start()`` binds a loopback TCP listener (``self.endpoint`` is
    what agents dial); ``spawn_local`` forks worker-agent processes
    for CI's faked multi-host topology; ``run`` drives a spec list at
    every registered agent concurrently and funnels finished rows
    through a single callback.
    """

    def __init__(self, token: Optional[str] = None,
                 tel: Optional[telemetry.Telemetry] = None,
                 idle_timeout: float = IDLE_TIMEOUT_S,
                 requeue_cap: int = REQUEUE_CAP):
        self.token = token
        self.tel = tel
        self.idle_timeout = idle_timeout
        self.requeue_cap = requeue_cap
        self.endpoint: Optional[str] = None
        self._cv = threading.Condition()
        self._agents: list[_Agent] = []
        self._procs: list[subprocess.Popen] = []
        self._work: deque = deque()
        self._stranded: list[dict] = []
        self._threads: list[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self._closed = False
        self.requeues = 0

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "HostAgentPool":
        ls, endpoint = listen_tcp(True)
        ls.settimeout(0.25)  # poll the closed flag; close() never hangs
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="agent-pool-accept")
        with self._cv:
            self._listener = ls
            self.endpoint = endpoint
            self._threads.append(t)
        t.start()
        return self

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            agents = list(self._agents)
            self._agents = []
            procs = list(self._procs)
            ls = self._listener
            threads = list(self._threads)
            self._cv.notify_all()
        for a in agents:
            try:
                _jframe(a.sock, a.wlock, {"op": "stop"})
            except OSError:
                pass
            try:
                a.sock.close()
            except OSError:
                pass
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=10)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()

    # ---- fleet ------------------------------------------------------------

    def spawn_local(self, hosts: list[str]) -> list:
        """CI's faked multi-host topology: one spawned worker-agent
        process per host name, all dialing this pool over loopback.
        The auth token travels via the environment, never argv (argv
        is world-readable in /proc)."""
        env = dict(os.environ)
        if self.token:
            env[ENV_TOKEN] = self.token
        # the agents import this package from wherever the campaign did,
        # whatever their working directory
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        procs = []
        for h in hosts:
            procs.append(subprocess.Popen(
                agent_argv(self.endpoint, h), env=env))
        with self._cv:
            self._procs.extend(procs)
        return procs

    def wait_ready(self, n: int, timeout: float = 120.0) -> int:
        """Block until ``n`` agents have registered (or the deadline
        passes); returns the registered count."""
        with self._cv:
            self._cv.wait_for(
                lambda: len(self._agents) >= n or self._closed,
                timeout=timeout)
            return len(self._agents)

    def hosts(self) -> list[str]:
        with self._cv:
            return sorted(a.host for a in self._agents)

    # ---- registration ------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                ls = self._listener
            try:
                sock, _ = ls.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by close()
            try:
                self._register(sock)
            except (OSError, ValueError, json.JSONDecodeError):
                logger.warning("agent registration failed", exc_info=True)
                try:
                    sock.close()
                except OSError:
                    pass

    def _register(self, sock: socket.socket) -> None:
        sock.settimeout(5.0)
        reader = FrameReader(sock)
        host = reader.read_preamble()
        frame = reader.recv_frame()
        if frame is None:
            raise ValueError("agent closed before registering")
        msg = json.loads(frame)
        if msg.get("op") != "register":
            raise ValueError(f"expected register, got {msg.get('op')!r}")
        if self.token and msg.get("token") != self.token:
            send_frame(sock, json.dumps(
                {"error": "bad auth token"}).encode())
            raise ValueError("agent auth token mismatch")
        host = str(msg.get("host") or host or "agent")
        send_frame(sock, json.dumps({"ok": True}).encode())
        sock.settimeout(self.idle_timeout)
        agent = _Agent(sock, reader, host)
        with self._cv:
            if self._closed:
                raise ValueError("pool closed")
            self._agents.append(agent)
            self._cv.notify_all()
        logger.info("agent %s registered", host)

    # ---- dispatch ----------------------------------------------------------

    def run(self, specs: list[dict], row_cb) -> None:
        """Drive every spec to completion: registered agents pull from
        a shared queue concurrently; specs stranded by agent deaths
        (or a fleet of zero agents) run inline in this process. Every
        finished row goes through ``row_cb`` exactly once, serialized
        under one lock."""
        cb_lock = threading.Lock()

        def _cb(row: dict) -> None:
            with cb_lock:
                row_cb(row)

        with self._cv:
            self._work = deque(specs)
            self._stranded = []
            agents = list(self._agents)
        feeders = []
        for a in agents:
            t = threading.Thread(target=self._drive, args=(a, _cb),
                                 daemon=True,
                                 name=f"agent-drive-{a.host}")
            feeders.append(t)
            t.start()
        for t in feeders:
            t.join()
        # whatever the fleet could not finish, the campaign runs itself:
        # a campaign must complete even if every agent died
        with self._cv:
            leftovers = list(self._work) + list(self._stranded)
            self._work = deque()
            self._stranded = []
        if leftovers:
            from .campaign import _pool_run
            logger.warning("running %d stranded specs inline",
                           len(leftovers))
            for spec in leftovers:
                _cb(_pool_run(spec))

    def _drive(self, agent: _Agent, cb) -> None:
        """One agent's feeder thread: pull a spec, run it remotely,
        repeat; on agent death re-queue the spec and retire."""
        while True:
            with self._cv:
                if self._closed or not self._work:
                    return
                spec = self._work.popleft()
            row = self._run_on_agent(agent, spec)
            if row is None:
                with self._cv:
                    n = int(spec.get("_requeues", 0))
                    spec["_requeues"] = n + 1
                    if n < self.requeue_cap:
                        self._work.appendleft(spec)
                    else:
                        self._stranded.append(spec)
                    self.requeues += 1
                if self.tel is not None:
                    self.tel.counter("campaign.agent_requeues")
                logger.warning("agent %s died; spec %s re-queued",
                               agent.host, spec.get("index"))
                try:
                    agent.sock.close()
                except OSError:
                    pass
                return
            cb(row)

    def _run_on_agent(self, agent: _Agent, spec: dict) -> Optional[dict]:
        """Ship one spec to an agent and wait for its row, skipping
        heartbeat frames; None means the agent is dead (the caller
        re-queues)."""
        opts = dict(spec["opts"])
        opts["host_id"] = agent.host
        wire_spec = dict(spec)
        wire_spec["opts"] = opts
        try:
            _jframe(agent.sock, agent.wlock,
                    {"op": "run", "spec": wire_spec})
            while True:
                frame = agent.reader.recv_frame()
                if frame is None:
                    return None  # clean EOF: agent exited
                msg = json.loads(frame)
                if "heartbeat" in msg:
                    continue  # alive, still working
                if msg.get("op") == "row":
                    row = msg["row"]
                    row.setdefault("host", agent.host)
                    return row
                logger.warning("agent %s sent unexpected frame %r",
                               agent.host, msg.get("op"))
        except (OSError, ValueError, json.JSONDecodeError):
            # socket.timeout (idle: no heartbeat for idle_timeout),
            # TornFrame, reset, garbage — all mean the same thing here
            return None


# ---- agent side ------------------------------------------------------------


def agent_main(endpoint: str, host: str,
               token: Optional[str] = None,
               beat_s: float = BEAT_S) -> int:
    """One worker-agent process: register with the pool, then loop
    run-spec -> row until told to stop. ``ENV_HOST`` is exported so
    every CheckerClient this process opens attributes itself as
    ``host`` (the JET-HOST preamble + ``service.host_submitted.*``)."""
    token = token if token is not None else os.environ.get(ENV_TOKEN)
    os.environ[ENV_HOST] = host
    sock = connect(endpoint, timeout=10.0)
    wlock = threading.Lock()
    send_preamble(sock, host)
    _jframe(sock, wlock, {"op": "register", "host": host, "token": token})
    reader = FrameReader(sock)
    frame = reader.recv_frame()
    resp = json.loads(frame) if frame else {}
    if not resp.get("ok"):
        logger.error("agent %s rejected by pool: %s", host,
                     resp.get("error", "connection closed"))
        return 1
    sock.settimeout(None)  # runs arrive whenever the campaign is ready
    logger.info("agent %s registered with %s", host, endpoint)
    stop = threading.Event()

    def _beat() -> None:
        k = 0
        while not stop.wait(beat_s):
            k += 1
            try:
                _jframe(sock, wlock, {"heartbeat": k})
            except OSError:
                return  # pool gone; the main loop will see EOF too

    threading.Thread(target=_beat, daemon=True,
                     name=f"agent-beat-{host}").start()
    try:
        while True:
            frame = reader.recv_frame()
            if frame is None:
                break  # pool closed the link: shut down
            msg = json.loads(frame)
            op = msg.get("op")
            if op == "stop":
                break
            if op != "run":
                logger.warning("agent %s: unknown op %r", host, op)
                continue
            # lazy import: the runner (and torch's device state) come
            # up on the first actual run, not at registration
            from .campaign import _pool_run
            row = _pool_run(msg["spec"])
            row["host"] = host
            _jframe(sock, wlock, {"op": "row", "row": row})
    except (OSError, ValueError, json.JSONDecodeError):
        logger.warning("agent %s: pool link died", host, exc_info=True)
        return 1
    finally:
        stop.set()
        try:
            sock.close()
        except OSError:
            pass
    return 0
