"""LinkProxy: one userspace TCP proxy in front of one node's port.

The unprivileged stand-in for the reference's iptables/netns layer
(nemesis.clj partitions drop packets with iptables over SSH): a
listening socket plus per-connection splice threads that consult a
router callback *per chunk*, so fault rules apply dynamically to
long-lived connections (raft streams, watch streams) the moment the
nemesis flips them — exactly like a kernel DROP rule appearing
mid-flight.

Semantics per direction (each TCP connection has two independently
ruled legs — upstream ``src -> node`` and downstream ``node -> src``):

- ``drop``       blackhole: bytes are read and discarded, the TCP
                 connection stays "up" (connects succeed, requests
                 hang until the client times out — iptables DROP, not
                 REJECT);
- ``drop_prob``  lossy link: each chunk is independently discarded
                 with this probability (netem-loss analog). Decisions
                 draw from the plane's seeded RNG via ``jitter()``, so
                 a given seed yields a reproducible drop pattern for a
                 given chunk sequence;
- ``latency_s``  + ``jitter_s``: each chunk sleeps ``latency +
                 U(0, jitter)`` before forwarding. One pump thread per
                 direction, so delivery stays FIFO under jitter;
- ``bandwidth_bps``  serialization delay of ``len(chunk)/bps``;
- ``slow_close_s``   a peer's FIN is held this long before the
                 half-close propagates.

Source attribution (who is dialing this node?) is sniffed from the
first bytes of ``kind="peer"`` connections and resolved by the plane:
the fake-etcd prober leads with a ``FAKE-ETCD-PEER <name>\\n``
preamble; real etcd's rafthttp requests carry an ``X-Server-From:
<member-id-hex>`` header the plane maps to a node name after setup
(member ids are only known once the real cluster has formed); and
checker-service TCP clients lead with ``JET-HOST <name>\\n``
(runner/transport.py), so the fleet's own control traffic partitions
exactly like SUT peer traffic. Sniffed bytes are always forwarded
(subject to the rules) — the sniff peeks, it never consumes.
Unattributable peer connections get ``src=None`` and are never
directionally dropped; ``kind="client"`` connections are attributed
``src="client"`` with no sniff.

Wall-clock and sleeps here are transport I/O, never verdict input
(net/* is DET-allowlisted in lint/policy.py); every shared attribute a
worker thread touches is written under ``self._lock``.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

#: splice chunk size; one rule consultation per chunk
CHUNK = 65536

#: how long the sniffer waits for attributable first bytes before
#: passing the connection through unattributed
SNIFF_TIMEOUT_S = 1.0

#: the fake-etcd prober's attribution preamble (round-tripped: the
#: peer listener answers FAKE-ETCD-OK <name>)
PEER_PREAMBLE = b"FAKE-ETCD-PEER "

#: real etcd rafthttp sender attribution header (lowercase for the
#: case-insensitive scan)
SERVER_FROM = b"x-server-from:"

#: checker-service host preamble (runner/transport.py PREAMBLE): the
#: generator host announces itself before its first frame
SVC_PREAMBLE = b"JET-HOST "

_UNDECIDED = object()


@dataclass(frozen=True)
class Rule:
    """The fault policy for one link direction at one instant."""

    drop: bool = False
    drop_prob: float = 0.0
    latency_s: float = 0.0
    jitter_s: float = 0.0
    bandwidth_bps: float = 0.0
    slow_close_s: float = 0.0


#: the no-fault rule (what route() returns on a healthy plane)
PASS = Rule()


def _close(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    try:
        sock.close()
    except OSError:
        pass


class LinkProxy:
    """One listening proxy fronting ``target_host:target_port``.

    ``router(src, dst, kind) -> Rule`` is consulted for every chunk on
    every leg; ``resolve(member_id_hex) -> name`` maps real-etcd
    X-Server-From values; ``jitter() -> float`` draws from the plane's
    seeded RNG; ``on_event(event, value)`` feeds telemetry counters.
    """

    def __init__(self, node: str, kind: str, target_port: int,
                 router: Callable[[Optional[str], str, str], Rule],
                 resolve: Optional[Callable[[str], Optional[str]]] = None,
                 jitter: Optional[Callable[[], float]] = None,
                 on_event: Optional[Callable[[str, float], None]] = None,
                 target_host: str = "127.0.0.1",
                 listen_host: str = "127.0.0.1"):
        self.node = node
        self.kind = kind
        self.target_host = target_host
        self.target_port = target_port
        self.router = router
        self.resolve = resolve or (lambda ident: None)
        self.jitter = jitter or (lambda: 0.0)
        self.on_event = on_event or (lambda event, value: None)
        self._lock = threading.Lock()
        self._closed = False
        #: live connections: [dsock, usock, legs_remaining] — both
        #: sockets are closed and the entry pruned once both pump legs
        #: have drained (the fake-etcd prober opens fresh connections
        #: every 0.25s, so anything short of eager cleanup leaks fds)
        self._conns: list[list] = []
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((listen_host, 0))
        self._lsock.listen(128)
        self.port = self._lsock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"net-accept-{node}-{kind}")
        self._accept_thread.start()

    # ---- accept / per-connection handling ----------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                dsock, _ = self._lsock.accept()
            except OSError:
                with self._lock:
                    if self._closed:
                        return  # listener closed by close()
                # transient accept failure (EMFILE, ECONNABORTED, ...):
                # dying here would be a permanent unhealable partition,
                # so surface it and keep serving
                self.on_event("accept_error", 1)
                time.sleep(0.05)
                continue
            t = threading.Thread(target=self._handle, args=(dsock,),
                                 daemon=True,
                                 name=f"net-conn-{self.node}-{self.kind}")
            t.start()

    def _handle(self, dsock: socket.socket) -> None:
        src: Optional[str] = "client"
        initial = b""
        if self.kind == "peer":
            src, initial = self._sniff(dsock)
        try:
            usock = socket.create_connection(
                (self.target_host, self.target_port), timeout=2.0)
        except OSError:
            # node down (killed): the proxy stays up, the dial fails —
            # clients see a reset, same as a dead node behind a LB
            self.on_event("dropped", 1)
            _close(dsock)
            return
        entry = [dsock, usock, 2]  # two pump legs outstanding
        with self._lock:
            if self._closed:
                _close(dsock)
                _close(usock)
                return
            self._conns.append(entry)
        down = threading.Thread(
            target=self._run_pump,
            args=(entry, usock, dsock, self.node, src),
            daemon=True, name=f"net-pump-{self.node}-{self.kind}")
        down.start()
        # upstream leg runs on this connection thread
        self._run_pump(entry, dsock, usock, src, self.node, initial)

    def _run_pump(self, entry: list, rsock: socket.socket,
                  wsock: socket.socket, src: Optional[str], dst: str,
                  initial: bytes = b"") -> None:
        try:
            self._pump(rsock, wsock, src, dst, initial)
        finally:
            self._leg_done(entry)

    def _leg_done(self, entry: list) -> None:
        """One pump leg finished; when both have, close both sockets
        and forget the connection (clean-EOF legs only half-close in
        _pump, so without this every finished connection leaks fds)."""
        with self._lock:
            entry[2] -= 1
            done = entry[2] <= 0
            if done:
                try:
                    self._conns.remove(entry)
                except ValueError:
                    pass  # already pruned by close()
        if done:
            _close(entry[0])
            _close(entry[1])

    # ---- attribution sniffing ----------------------------------------------

    def _attribute(self, buf: bytes):
        """``_UNDECIDED`` (need more bytes), a node name, or None
        (unattributable — pass through undropped)."""
        for preamble in (PEER_PREAMBLE, SVC_PREAMBLE):
            head = buf[:len(preamble)]
            if not preamble.startswith(head):
                continue
            # a line preamble (fake-etcd prober or checker-service
            # host announcement) — or a prefix of one
            if not buf.startswith(preamble):
                return _UNDECIDED
            nl = buf.find(b"\n")
            if nl < 0:
                return _UNDECIDED if len(buf) < 256 else None
            return buf[len(preamble):nl].decode(
                "utf-8", "replace").strip() or None
        # HTTP request (real etcd rafthttp): scan the header block
        lower = buf.lower()
        at = lower.find(SERVER_FROM)
        if at >= 0:
            eol = buf.find(b"\r\n", at)
            if eol < 0:
                return _UNDECIDED
            ident = buf[at + len(SERVER_FROM):eol].decode(
                "ascii", "replace").strip().lower()
            return self.resolve(ident)
        if b"\r\n\r\n" in lower:
            return None  # full header block, no attribution header
        return _UNDECIDED

    def _sniff(self, sock: socket.socket) -> tuple[Optional[str], bytes]:
        sock.settimeout(SNIFF_TIMEOUT_S)
        buf = b""
        src: Optional[str] = None
        try:
            for _ in range(8):
                chunk = sock.recv(4096)
                if not chunk:
                    break
                buf += chunk
                got = self._attribute(buf)
                if got is not _UNDECIDED:
                    src = got
                    break
                if len(buf) >= CHUNK:
                    break
        except OSError:
            pass
        try:
            sock.settimeout(None)
        except OSError:
            pass
        return src, buf

    # ---- splice pumps ------------------------------------------------------

    def _forward(self, data: bytes, wsock: socket.socket,
                 src: Optional[str], dst: str, state: dict) -> None:
        rule = self.router(src, dst, self.kind)
        if rule.drop:
            if not state.get("dropped"):
                state["dropped"] = True
                self.on_event("dropped", 1)
            return  # blackhole: discard, keep reading
        if rule.drop_prob > 0 and self.jitter() < rule.drop_prob:
            # lossy link: this chunk vanishes but the connection stays
            # up — TCP-level loss seen by the application as a stall or
            # a torn stream, not a closed socket
            self.on_event("chunk_dropped", len(data))
            return
        delay = rule.latency_s
        if rule.jitter_s:
            delay += rule.jitter_s * self.jitter()
        if rule.bandwidth_bps > 0:
            delay += len(data) / rule.bandwidth_bps
        if delay > 0:
            time.sleep(delay)
            self.on_event("delayed", len(data))
        wsock.sendall(data)

    def _pump(self, rsock: socket.socket, wsock: socket.socket,
              src: Optional[str], dst: str, initial: bytes = b"") -> None:
        state: dict = {}
        try:
            pending = initial
            while True:
                if pending:
                    self._forward(pending, wsock, src, dst, state)
                pending = rsock.recv(CHUNK)
                if not pending:
                    break
            rule = self.router(src, dst, self.kind)
            if rule.slow_close_s > 0:
                time.sleep(rule.slow_close_s)
            try:
                wsock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
        except OSError:
            _close(rsock)
            _close(wsock)

    # ---- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
            self._conns.clear()
        _close(self._lsock)
        for dsock, usock, _legs in conns:
            _close(dsock)
            _close(usock)
