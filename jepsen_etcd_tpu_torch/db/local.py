"""Local control plane: spawn, supervise, and fault N etcd processes.

The db.clj analog for processes on THIS machine instead of over SSH
(db.clj:72-105,192-271): where the reference runs `etcd` on five debian
nodes and faults it with grepkill, this module owns the OS processes
directly — subprocess spawn with the reference's flag set (peer/client
URLs, --snapshot-count, --unsafe-no-fsync, corrupt-check flags,
db.clj:79-100), SIGKILL/SIGSTOP/SIGCONT delivery, data-dir wipes,
member grow/shrink via the real member API, readiness polling with
bounded exponential backoff, crash-loop detection, and per-node log
collection into the run store.

The binary is pluggable: a real `etcd` from PATH (or --etcd-binary)
when one exists, else the bundled fake-etcd stub (db/fake_etcd.py) so
every process-management path runs end-to-end without etcd installed.
Node identity is a NAME (n1..nN) everywhere — nemesis targets, members,
log dirs — and this module owns the name -> client URL mapping
(client_url), which the client factory consults in local mode.

Fault support matrix (compose.py enforces it with specific refusals):
kill / pause / member / admin work directly; partition and latency ride
the userspace TCP proxy plane (net/plane.py, ``--net-proxy`` — auto-set
when those faults are requested): every advertised client and peer URL
points at a per-node ingress proxy while the process listens on its
real port, so drop/latency rules apply to all inter-node and client
traffic without netns/iptables privileges. Clock skew still needs
per-process time virtualization and stays refused.
"""

from __future__ import annotations

import logging
import os
import re
import shlex
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
from typing import Optional

from ..runner.sim import current_loop, sleep, gather, SECOND
from ..sut.errors import SimError
from ..sut.http_gateway import member_id_for_peer_urls
from .live import _live_client_cls

logger = logging.getLogger("jepsen_etcd_tpu_torch.db.local")

FAKE_ETCD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fake_etcd.py")

#: how many startup deaths count as a crash loop (db.clj restarts a
#: crashed node a few times before declaring it wedged)
MAX_START_RETRIES = 3


def resolve_binary(spec) -> list[str]:
    """--etcd-binary -> argv prefix. Accepts a list (tests pass
    [sys.executable, fake_etcd.py]), a shell-ish string, the literal
    "fake", or None (a real etcd from PATH if present, else the
    bundled fake stub)."""
    if isinstance(spec, (list, tuple)) and spec:
        return list(spec)
    if isinstance(spec, str) and spec.strip() and spec.strip() != "fake":
        return shlex.split(spec)
    if not (isinstance(spec, str) and spec.strip() == "fake"):
        real = shutil.which("etcd")
        if real:
            return [real]
        logger.warning("no etcd binary on PATH: using the bundled "
                       "fake-etcd stub (process control is real, the "
                       "store is per-node and non-replicated)")
    return [sys.executable, FAKE_ETCD]


def free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


class LocalDb:
    """jepsen.db over locally-spawned etcd processes."""

    def __init__(self, opts: dict):
        self.opts = opts or {}
        self.binary = resolve_binary(self.opts.get("etcd_binary"))
        self.extra_env: dict = dict(self.opts.get("etcd_env") or {})
        self.members: Optional[set] = None
        self.next_node_id = 0
        self.initialized = False
        # node -> (client_port, peer_port); allocated lazily per node
        self.ports: dict[str, tuple[int, int]] = {}
        # userspace network fault plane (--net-proxy): advertised URLs
        # route through per-node ingress proxies; None = direct wiring
        self.plane = None
        # node -> (client_proxy_port, peer_proxy_port) when fronted
        self.proxy_ports: dict[str, tuple[int, int]] = {}
        if self.opts.get("net_proxy"):
            from ..net.plane import NetPlane
            self.plane = NetPlane(seed=int(self.opts.get("seed") or 0))
        # node -> live Popen (dead ones are reaped out on kill/start)
        self.procs: dict[str, subprocess.Popen] = {}
        # every Popen ever spawned, for teardown + leak accounting
        self.all_procs: list[subprocess.Popen] = []
        self._log_handles: dict[str, object] = {}
        root = self.opts.get("etcd_data_dir")
        if root:
            os.makedirs(root, exist_ok=True)
            self.root = root
            self._own_root = False
        else:
            self.root = tempfile.mkdtemp(prefix="jepsen-etcd-local-")
            self._own_root = True
        # the unique token a /proc cmdline scan can find leaked
        # children by: the absolute data root (every spawn's
        # --data-dir starts with it; a basename like "data" would
        # false-positive on unrelated processes)
        self.token = os.path.abspath(self.root)

    # ---- addressing --------------------------------------------------------

    def _ensure_ports(self, node: str) -> None:
        if node not in self.ports:
            self.ports[node] = (free_port(), free_port())
            if self.plane is not None:
                client_port, peer_port = self.ports[node]
                self.proxy_ports[node] = (
                    self.plane.front(node, "client", client_port),
                    self.plane.front(node, "peer", peer_port))

    def client_url(self, node: str) -> str:
        """What clients (and other nodes' member APIs) dial: the
        ingress proxy when the net plane is up, else the real port."""
        self._ensure_ports(node)
        if self.plane is not None:
            return f"http://127.0.0.1:{self.proxy_ports[node][0]}"
        return f"http://127.0.0.1:{self.ports[node][0]}"

    def peer_url(self, node: str) -> str:
        """The ADVERTISED peer URL (what --initial-cluster carries, so
        every peer dial crosses the target's ingress proxy)."""
        self._ensure_ports(node)
        if self.plane is not None:
            return f"http://127.0.0.1:{self.proxy_ports[node][1]}"
        return f"http://127.0.0.1:{self.ports[node][1]}"

    def listen_client_url(self, node: str) -> str:
        """The real port the process binds (proxied or not)."""
        self._ensure_ports(node)
        return f"http://127.0.0.1:{self.ports[node][0]}"

    def listen_peer_url(self, node: str) -> str:
        self._ensure_ports(node)
        return f"http://127.0.0.1:{self.ports[node][1]}"

    def data_dir(self, node: str) -> str:
        return os.path.join(self.root, node)

    def log_path(self, node: str) -> str:
        return os.path.join(self.root, f"{node}.log")

    def _client(self, test: dict, node: str):
        cls = _live_client_cls(test if isinstance(test, dict) else
                               self.opts)
        c = cls(self.client_url(node))
        c.node = node
        return c

    # ---- spawning ----------------------------------------------------------

    def _argv(self, node: str, state: str, roster: list[str]) -> list[str]:
        """The reference's etcd invocation (db.clj:79-100)."""
        o = self.opts
        argv = list(self.binary) + [
            "--name", node,
            "--data-dir", self.data_dir(node),
            "--listen-client-urls", self.listen_client_url(node),
            "--advertise-client-urls", self.client_url(node),
            "--listen-peer-urls", self.listen_peer_url(node),
            "--initial-advertise-peer-urls", self.peer_url(node),
            "--initial-cluster",
            ",".join(f"{n}={self.peer_url(n)}" for n in sorted(roster)),
            "--initial-cluster-state", state,
            "--initial-cluster-token",
            "jepsen-" + os.path.basename(self.root.rstrip("/")),
            "--snapshot-count", str(o.get("snapshot_count") or 100),
            "--logger", "zap",
            "--log-outputs", "stderr",
        ]
        if o.get("unsafe_no_fsync"):
            argv.append("--unsafe-no-fsync")
        if o.get("corrupt_check"):
            # db.clj:97-99: verify at boot, then sweep every minute
            argv += ["--experimental-initial-corrupt-check=true",
                     "--experimental-corrupt-check-time", "1m"]
        return argv

    def _spawn(self, node: str, state: str,
               roster: Optional[list[str]] = None) -> subprocess.Popen:
        roster = roster if roster is not None else sorted(
            self.members or [node])
        os.makedirs(self.data_dir(node), exist_ok=True)
        old = self._log_handles.pop(node, None)
        if old is not None:
            old.close()
        log = open(self.log_path(node), "ab")
        self._log_handles[node] = log
        env = dict(os.environ)
        env.update({k: str(v) for k, v in self.extra_env.items()})
        proc = subprocess.Popen(self._argv(node, state, roster),
                                stdout=log, stderr=log, env=env)
        self.procs[node] = proc
        self.all_procs.append(proc)
        logger.info("spawned %s (pid %d, state %s)", node, proc.pid,
                    state)
        return proc

    def _log_tail(self, node: str, n: int = 12) -> str:
        try:
            with open(self.log_path(node), "rb") as f:
                lines = f.read().decode("utf-8", "replace").splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return "<no log>"

    async def _await_node_ready(self, test: dict, node: str,
                                state: str = "existing",
                                max_wait_s: float = 30.0,
                                respawn: bool = True) -> None:
        """Poll status with bounded exponential backoff until the node
        reports a leader (client.clj:652-661). A process that dies
        during startup is respawned up to MAX_START_RETRIES times;
        past that it is a crash loop and setup fails with the log tail
        as evidence."""
        loop = current_loop()
        deadline = loop.now + int(max_wait_s * SECOND)
        delay, respawns = 0.05, 0
        while True:
            proc = self.procs.get(node)
            if proc is None or proc.poll() is not None:
                respawns += 1
                if not respawn or respawns > MAX_START_RETRIES:
                    rc = proc.returncode if proc is not None else "?"
                    raise SimError(
                        "crash-loop",
                        f"{node} died {respawns}x during startup "
                        f"(last exit {rc}); log tail:\n"
                        f"{self._log_tail(node)}")
                self._spawn(node, state)
            else:
                c = self._client(test, node)
                try:
                    st = await c.status()
                    if st.get("leader"):
                        return
                except (SimError, TimeoutError):
                    pass
                finally:
                    c.close()
            if loop.now > deadline:
                raise SimError(
                    "unavailable",
                    f"{node} never became ready in {max_wait_s:.0f}s; "
                    f"log tail:\n{self._log_tail(node)}")
            await sleep(int(delay * SECOND))
            delay = min(delay * 2, 2.0)

    # ---- DB protocol -------------------------------------------------------

    async def setup(self, test: dict) -> None:
        self.members = set(test["nodes"])
        ids = [int(m.group(1)) for n in test["nodes"]
               if (m := re.fullmatch(r"n(\d+)", n))]
        self.next_node_id = max(ids, default=len(test["nodes"]))
        for node in sorted(self.members):
            self._ensure_ports(node)  # full roster before any argv
        for node in sorted(self.members):
            self._spawn(node, "new")
        loop = current_loop()
        await gather(*[
            loop.spawn(self._await_node_ready(test, n, state="new"))
            for n in sorted(self.members)])
        self.initialized = True
        if self.plane is not None:
            await self._register_member_ids(test)
        logger.info("local cluster ready: %s (binary %s)",
                    sorted(self.members), self.binary[0])

    async def _register_member_ids(self, test: dict) -> None:
        """Teach the net plane real member-id -> name attribution: a
        real etcd's rafthttp dials carry X-Server-From: <member-id-hex>
        and the ids are only known once the cluster has formed."""
        c = self._client(test, sorted(self.members)[0])
        try:
            mapping = {}
            for m in await c.member_list():
                if m.get("name") and m.get("id") is not None:
                    mapping[f"{int(m['id']):x}"] = m["name"]
            self.plane.register_member_ids(mapping)
        except (SimError, TimeoutError):
            # attribution degrades gracefully: unattributed peer links
            # are never directionally dropped
            logger.warning("member-id attribution unavailable")
        finally:
            c.close()

    async def teardown(self, test: dict) -> None:
        self.stop_all()

    def stop_all(self) -> None:
        """SIGKILL every child ever spawned and reap it. SIGKILL lands
        on SIGSTOP'd processes too, so paused nodes cannot outlive the
        run."""
        for proc in self.all_procs:
            if proc.poll() is None:
                try:
                    proc.kill()
                except ProcessLookupError:
                    pass
        for proc in self.all_procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                logger.error("pid %d failed to die on SIGKILL",
                             proc.pid)
        for h in self._log_handles.values():
            h.close()
        self._log_handles.clear()
        self.procs.clear()
        if self.plane is not None:
            self.plane.close()

    def leaked_pids(self) -> list[int]:
        """Live children after teardown: tracked Popens still running,
        plus any /proc process whose cmdline carries this run's unique
        data-dir token (catches a child we lost track of)."""
        leaked = {p.pid for p in self.all_procs if p.poll() is None}
        try:
            for pid in os.listdir("/proc"):
                if not pid.isdigit():
                    continue
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        cmd = f.read().decode("utf-8", "replace")
                except OSError:
                    continue
                if self.token in cmd and int(pid) != os.getpid():
                    leaked.add(int(pid))
        except OSError:  # pragma: no cover (no /proc: macOS etc.)
            pass
        return sorted(leaked)

    def log_files(self, test: dict) -> dict:
        """node -> etcd log lines (db.clj:234-242), read back from the
        per-node capture files for the run store."""
        out = {}
        for node in sorted(set(self.ports) | set(self.members or ())):
            try:
                with open(self.log_path(node), "rb") as f:
                    out[node] = f.read().decode(
                        "utf-8", "replace").splitlines()
            except OSError:
                pass
        return out

    # ---- Process protocol --------------------------------------------------

    def start(self, test: dict, node: str) -> str:
        proc = self.procs.get(node)
        if proc is not None and proc.poll() is None:
            return "already-running"
        self._spawn(node, "existing" if self.initialized else "new")
        return "started"

    def kill(self, test: dict, node: str) -> str:
        return self.kill_node(test, node,
                              wipe=bool(test.get("wipe_on_kill")))

    def kill_node(self, test: dict, node: str,
                  wipe: bool = False) -> str:
        """SIGKILL, optionally wiping the data dir while it's down
        (kill! + lazyfs lose-unfsynced-writes analog, db.clj:264-267)."""
        proc = self.procs.get(node)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        if wipe:
            self.wipe(test, node)
        return "killed"

    def _signal(self, node: str, sig: int) -> bool:
        proc = self.procs.get(node)
        if proc is None or proc.poll() is not None:
            return False
        try:
            proc.send_signal(sig)
            return True
        except ProcessLookupError:  # raced with its death
            return False

    def pause(self, test: dict, node: str) -> str:
        return ("paused" if self._signal(node, signal.SIGSTOP)
                else "not-running")

    def resume(self, test: dict, node: str) -> str:
        return ("resumed" if self._signal(node, signal.SIGCONT)
                else "not-running")

    def wipe(self, test: dict, node: str) -> str:
        """Destroy the data dir (wipe!, db.clj:247-255). Only sane on a
        dead node; the caller sequences kill before wipe."""
        shutil.rmtree(self.data_dir(node), ignore_errors=True)
        os.makedirs(self.data_dir(node), exist_ok=True)
        return "wiped"

    # ---- Primary protocol --------------------------------------------------

    async def primaries(self, test: dict) -> list[str]:
        """Highest-raft-term status answer wins (db.clj:38-52), mapped
        back to the node whose own member id IS the reported leader."""
        loop = current_loop()

        async def ask(node):
            c = self._client(test, node)
            try:
                return node, await c.status()
            except (SimError, TimeoutError):
                return node, None
            finally:
                c.close()

        answers = [a for a in await gather(
            *[loop.spawn(ask(n)) for n in sorted(self.members or ())])
            if a[1] is not None]
        if not answers:
            return []
        _, best = max(answers, key=lambda a: a[1].get("raft-term", 0))
        leader_id = best.get("leader")
        if not leader_id:
            return []
        for node, st in answers:
            mid = int(st.get("header", {}).get("member_id", 0) or 0)
            if mid == int(leader_id):
                return [node]
        return []

    # ---- membership (db.clj:128-190) ---------------------------------------

    async def grow(self, test: dict) -> str:
        """Add a member via the real member API on a random current
        node, then spawn and await the new process."""
        loop = current_loop()
        self.next_node_id += 1
        new = f"n{self.next_node_id}"
        self._ensure_ports(new)
        via = loop.rng.choice(sorted(self.members))
        c = self._client(test, via)
        try:
            await c.member_add_urls([self.peer_url(new)])
        finally:
            c.close()
        self.members.add(new)
        self._spawn(new, "existing")
        await self._await_node_ready(test, new, max_wait_s=15)
        return new

    async def shrink(self, test: dict) -> str:
        """Remove a random member via another member's API; kill and
        wipe the victim."""
        loop = current_loop()
        if len(self.members or ()) <= 1:
            raise SimError("unhealthy-cluster", "cannot shrink to zero")
        victim = loop.rng.choice(sorted(self.members))
        others = sorted(self.members - {victim})
        via = loop.rng.choice(others)
        c = self._client(test, via)
        try:
            mid = None
            victim_peer = self.peer_url(victim)
            for m in await c.member_list():
                if m["name"] == victim or \
                        victim_peer in m.get("peer-urls", ()):
                    mid = m["id"]
                    break
            if mid is None:
                # an added-but-renamed member: fall back to the shared
                # peer-URL id derivation
                mid = member_id_for_peer_urls([victim_peer])
            try:
                await c.remove_member_by_id(mid)
            except SimError as e:
                # "member not found" means the goal state — victim not
                # a member — already holds on this node (fake nodes
                # don't replicate membership; real etcd can race a
                # concurrent removal). Anything else is a real failure.
                if "member not found" not in str(e).lower():
                    raise
        finally:
            c.close()
        self.kill_node(test, victim, wipe=True)
        self.members.discard(victim)
        return victim


def local_db(opts: dict) -> LocalDb:
    return LocalDb(opts)
