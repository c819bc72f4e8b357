"""Unit coverage for the port's userspace proxy plane (net/proxy.py,
net/plane.py), the shapes of the reference's tests/test_net_proxy.py: one-way and bidirectional drops, attribution (fake
preamble and real-etcd X-Server-From), latency FIFO under jitter,
slow-close, bandwidth caps, dynamic rule flips on live connections,
and plane routing/heal semantics — all against a local echo server,
no cluster required."""

import socket
import threading
import time

import pytest

from jepsen_etcd_tpu_torch.net.plane import NetPlane
from jepsen_etcd_tpu_torch.net.proxy import PASS, PEER_PREAMBLE, LinkProxy

SHORT = 0.5   # recv timeout that proves "nothing arrived"


class EchoServer:
    """Echoes every byte back; closes its side on client EOF."""

    def __init__(self):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(16)
        self.port = self.srv.getsockname()[1]
        self._conns = []
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._echo, args=(conn,),
                             daemon=True).start()

    def _echo(self, conn):
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    break
                conn.sendall(data)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def close(self):
        try:
            self.srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


@pytest.fixture()
def echo():
    srv = EchoServer()
    yield srv
    srv.close()


@pytest.fixture()
def plane():
    pl = NetPlane(seed=7)
    yield pl
    pl.close()


def peer_conn(port, name="n2", payload=b""):
    """Dial a peer-kind proxy with the fake-etcd attribution preamble."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(PEER_PREAMBLE + name.encode() + b"\n" + payload)
    return s


def recv_exact(sock, n, timeout=5.0):
    sock.settimeout(timeout)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def assert_silent(sock, timeout=SHORT):
    sock.settimeout(timeout)
    with pytest.raises(TimeoutError):
        sock.recv(1)


# ---- routing table ---------------------------------------------------------

def test_route_semantics(plane):
    plane.nodes.update({"n1", "n2", "n3"})
    assert plane.route("n2", "n1", "peer") is PASS
    plane.partition_pairs({("n2", "n1"), frozenset(("n1", "n3"))})
    # ordered tuple: one direction only
    assert plane.route("n2", "n1", "peer").drop is True
    assert plane.route("n1", "n2", "peer").drop is False
    # frozenset: both directions
    assert plane.route("n1", "n3", "peer").drop is True
    assert plane.route("n3", "n1", "peer").drop is True
    # unattributed and client legs are never directionally dropped
    assert plane.route(None, "n1", "peer").drop is False
    assert plane.route("client", "n1", "client").drop is False
    plane.heal_partition()
    assert plane.route("n2", "n1", "peer") is PASS


def test_partition_groups_cross_block(plane):
    plane.nodes.update({"n1", "n2", "n3", "n4", "n5"})
    plane.partition([["n1", "n2"], ["n3", "n4", "n5"]])
    assert plane.route("n1", "n3", "peer").drop is True
    assert plane.route("n4", "n2", "peer").drop is True
    assert plane.route("n1", "n2", "peer").drop is False
    assert plane.route("n3", "n5", "peer").drop is False
    stats = plane.stats()
    assert stats["blocked"] == 6  # 2x3 cross pairs
    plane.heal()
    assert plane.stats()["blocked"] == 0


# ---- one-way and bidirectional drops ---------------------------------------

def test_one_way_drop_blocks_only_that_direction(echo, plane):
    port = plane.front("n1", "peer", echo.port)
    # baseline: attributed conn echoes (preamble is forwarded too)
    s = peer_conn(port, "n2", b"hello")
    want = PEER_PREAMBLE + b"n2\nhello"
    assert recv_exact(s, len(want)) == want

    # block n2 -> n1: upstream bytes blackhole, nothing echoes back
    plane.partition_pairs({("n2", "n1")})
    s.sendall(b"dropped?")
    assert_silent(s)

    # the reverse direction alone: upstream flows, the ECHO blackholes
    plane.partition_pairs({("n1", "n2")})
    s2 = peer_conn(port, "n2", b"reverse")
    assert_silent(s2)

    # heal: the SAME long-lived connection flows again (per-chunk
    # rule consultation, no reconnect needed)
    plane.heal_partition()
    s.sendall(b"back")
    assert recv_exact(s, len(b"back")) == b"back"
    s.close()
    s2.close()


def test_bidirectional_drop_and_client_immunity(echo, plane):
    ppeer = plane.front("n1", "peer", echo.port)
    pcli = plane.front("n1", "client", echo.port)
    plane.partition_pairs({frozenset(("n1", "n2"))})
    s = peer_conn(ppeer, "n2", b"x")
    assert_silent(s)
    # client legs never partition-drop: clients reach their own node
    c = socket.create_connection(("127.0.0.1", pcli), timeout=5)
    c.sendall(b"client-bytes")
    assert recv_exact(c, len(b"client-bytes")) == b"client-bytes"
    s.close()
    c.close()


def test_unattributed_peer_conn_never_dropped(echo, plane):
    port = plane.front("n1", "peer", echo.port)
    plane.partition_pairs({("n2", "n1"), frozenset(("n1", "n2")),
                           frozenset(("n1", "n3"))})
    # a full HTTP header block with no X-Server-From: src=None
    req = b"GET /raft HTTP/1.1\r\nHost: n1\r\n\r\n"
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(req)
    assert recv_exact(s, len(req)) == req
    s.close()


def test_x_server_from_attribution(echo, plane):
    """Real-etcd rafthttp attribution: the member-id hex in
    X-Server-From maps to a name via register_member_ids, and the
    attributed conn obeys directional drops."""
    port = plane.front("n1", "peer", echo.port)
    plane.register_member_ids({"8E9E05C52164694D": "n2"})
    plane.partition_pairs({("n2", "n1")})
    req = (b"POST /raft/stream HTTP/1.1\r\nHost: n1\r\n"
           b"X-Server-From: 8e9e05c52164694d\r\n\r\n")
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(req)
    assert_silent(s)
    # an unknown member id resolves to None -> passes through
    req2 = (b"POST /raft/stream HTTP/1.1\r\nHost: n1\r\n"
            b"X-Server-From: feedfacedeadbeef\r\n\r\n")
    s2 = socket.create_connection(("127.0.0.1", port), timeout=5)
    s2.sendall(req2)
    assert recv_exact(s2, len(req2)) == req2
    s.close()
    s2.close()


# ---- latency / bandwidth / slow-close --------------------------------------

def test_latency_floor_and_fifo_under_jitter(echo, plane):
    port = plane.front("n1", "client", echo.port)
    plane.set_latency(delta_ms=40, jitter_ms=30)
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    t0 = time.monotonic()
    msgs = [b"msg-%d|" % i for i in range(5)]
    for m in msgs:
        s.sendall(m)
        time.sleep(0.01)
    want = b"".join(msgs)
    got = recv_exact(s, len(want))
    elapsed = time.monotonic() - t0
    # FIFO: one pump thread per direction sleeps inline, so jitter
    # cannot reorder delivery
    assert got == want
    # the floor: at least one chunk each way paid >= delta
    assert elapsed >= 0.08, elapsed
    plane.clear_latency()
    # cleared: a round trip is fast again
    t0 = time.monotonic()
    s.sendall(b"fast")
    assert recv_exact(s, 4) == b"fast"
    assert time.monotonic() - t0 < 1.0
    s.close()


def test_bandwidth_cap_serialization_delay(echo, plane):
    port = plane.front("n1", "client", echo.port)
    plane.set_bandwidth(256 * 1024)  # bytes/s
    payload = b"\xab" * (64 * 1024)  # 0.25 s per direction at the cap
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    t0 = time.monotonic()
    s.sendall(payload)
    got = recv_exact(s, len(payload), timeout=10)
    elapsed = time.monotonic() - t0
    assert got == payload
    assert elapsed >= 0.25, elapsed
    s.close()


def test_slow_close_delays_fin_propagation(echo, plane):
    port = plane.front("n1", "client", echo.port)
    plane.set_slow_close(0.3)
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(b"bye")
    assert recv_exact(s, 3) == b"bye"
    t0 = time.monotonic()
    s.shutdown(socket.SHUT_WR)
    # EOF must cross upstream (0.3 s hold), bounce off the echo
    # server's close, and cross back (another hold)
    s.settimeout(10)
    while True:
        if s.recv(4096) == b"":
            break
    assert time.monotonic() - t0 >= 0.3
    s.close()


# ---- lossy links (drop_prob) -----------------------------------------------

def test_drop_prob_route_clamp_and_heal(plane):
    assert plane.route("client", "n1", "client") is PASS
    plane.set_drop_prob(0.25)
    # loss applies to every leg, client and peer alike (netem-on-the-
    # interface semantics, unlike directional partition drops)
    assert plane.route("client", "n1", "client").drop_prob == 0.25
    assert plane.route("n2", "n1", "peer").drop_prob == 0.25
    assert plane.stats()["drop_prob"] == 0.25
    plane.clear_drop_prob()
    assert plane.route("client", "n1", "client") is PASS
    plane.set_drop_prob(1.5)  # clamped
    assert plane.stats()["drop_prob"] == 1.0
    plane.heal()
    assert plane.stats()["drop_prob"] == 0.0
    assert plane.route("client", "n1", "client") is PASS


class _SinkSock:
    """Records what _forward lets through; never blocks."""

    def __init__(self):
        self.chunks = []

    def sendall(self, data):
        self.chunks.append(data)


def _drop_pattern(seed, n=64):
    """The per-chunk pass/drop pattern a fresh plane with this seed
    produces for a fixed chunk sequence (driving _forward directly:
    TCP chunk coalescing never enters, so the pattern is a pure
    function of the seed)."""
    plane = NetPlane(seed=seed)
    plane.set_drop_prob(0.5)
    proxy = LinkProxy("n1", "client", target_port=1,
                      router=plane.route, jitter=plane._jitter)
    try:
        wsock = _SinkSock()
        state = {}
        pattern = []
        for i in range(n):
            before = len(wsock.chunks)
            proxy._forward(b"chunk-%d" % i, wsock, "client", "n1", state)
            pattern.append(len(wsock.chunks) > before)
        return pattern
    finally:
        proxy.close()
        plane.close()


def test_drop_prob_seeded_determinism():
    a = _drop_pattern(seed=7)
    b = _drop_pattern(seed=7)
    assert a == b, "same seed must reproduce the same loss pattern"
    assert any(a) and not all(a), "p=0.5 over 64 chunks: both outcomes"
    c = _drop_pattern(seed=8)
    assert a != c, "a different seed draws a different pattern"


def test_drop_prob_end_to_end_and_recovery(echo, plane):
    """p=1.0 loses every chunk while the connection stays up; clearing
    the rule restores the SAME connection (per-chunk consultation)."""
    port = plane.front("n1", "client", echo.port)
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(b"before")
    assert recv_exact(s, len(b"before")) == b"before"
    plane.set_drop_prob(1.0)
    s.sendall(b"lost")
    assert_silent(s)
    plane.clear_drop_prob()
    s.sendall(b"after")
    assert recv_exact(s, len(b"after")) == b"after"
    s.close()


# ---- lifecycle -------------------------------------------------------------

def test_dead_upstream_counts_dropped_conn(plane):
    """Fronting a dead port: the dial fails, the client sees EOF/reset,
    the proxy survives for the next connection."""
    dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()  # nothing listens here now
    port = plane.front("n1", "client", dead_port)
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.settimeout(5)
    try:
        assert s.recv(1) == b""
    except OSError:
        pass  # ECONNRESET is as good as EOF here
    s.close()


def test_plane_close_is_idempotent(echo, plane):
    plane.front("n1", "client", echo.port)
    plane.front("n1", "peer", echo.port)
    assert plane.stats()["links"] == 2
    plane.close()
    plane.close()
