"""Framed socket transport of the checker service (a copy of the
reference's ``runner/transport.py``, which imports no JAX).

One wire shape, two socket families:

- a filesystem path         -> AF_UNIX stream socket (single host)
- ``tcp://HOST:PORT``       -> AF_INET stream socket (multi-host)

Frames are 8-byte little-endian length prefixes followed by the
payload. The length is validated against ``max_frame`` BEFORE any
payload allocation, so a corrupt or adversarial prefix can never
balloon the heap. EOF exactly on a frame boundary is a clean close
(``None``); EOF anywhere inside a frame — mid-header or mid-payload —
raises ``TornFrame`` so readers can tell a peer that finished from a
link that died.

TCP connections open with a one-line text preamble::

    JET-HOST <name>\\n

naming the sending host: the service reads it for per-host counter
attribution (``service.host_submitted.<host>``), and the reference's
``net/`` proxy plane sniffs the same line to attribute the connection.
Unix-socket connections skip the preamble (same host, nothing to
attribute).
"""

from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

_LEN = struct.Struct("<Q")

#: refuse frames past this size (a corrupt length prefix must not
#: allocate the heap): 1 GiB >> any real campaign's per-request packs
MAX_FRAME = 1 << 30

#: connection preamble on TCP transports: ``JET-HOST <name>\n`` — the
#: net/ proxy attributes on it, the service counts per-host on it
PREAMBLE = b"JET-HOST "

#: longest host name the preamble will carry (sanity cap so a garbage
#: stream can't make ``read_preamble`` buffer forever hunting for \n)
MAX_PREAMBLE = 256


class TornFrame(ValueError):
    """EOF inside a frame: the peer (or the link) died mid-message."""


def is_tcp(endpoint: str) -> bool:
    return isinstance(endpoint, str) and endpoint.startswith("tcp://")


def parse_tcp(endpoint: str) -> Tuple[str, int]:
    """``tcp://HOST:PORT`` -> (host, port)."""
    rest = endpoint[len("tcp://"):]
    host, _, port = rest.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad tcp endpoint {endpoint!r} "
                         "(want tcp://HOST:PORT)")
    return host, int(port)


def connect(endpoint: str, timeout: Optional[float] = None) -> socket.socket:
    """Open a stream socket to an endpoint (unix path or tcp:// URL)."""
    if is_tcp(endpoint):
        host, port = parse_tcp(endpoint)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect((host, port))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    else:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(endpoint)
    return s


def listen_tcp(spec) -> Tuple[socket.socket, str]:
    """Bind a TCP listener from a spec (True -> loopback ephemeral,
    int -> loopback port, "HOST:PORT" -> explicit) and return
    ``(listener, "tcp://host:port")``."""
    host, port = "127.0.0.1", 0
    if spec is True or spec is None:
        pass
    elif isinstance(spec, int):
        port = spec
    elif isinstance(spec, str) and spec:
        if ":" in spec:
            h, _, p = spec.rpartition(":")
            host, port = (h or "127.0.0.1"), int(p)
        else:
            port = int(spec)
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind((host, port))
    ls.listen(64)
    bhost, bport = ls.getsockname()[:2]
    return ls, f"tcp://{bhost}:{bport}"


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def send_preamble(sock: socket.socket, host: str) -> None:
    sock.sendall(PREAMBLE + host.encode() + b"\n")


class FrameReader:
    """Buffered, re-entrant frame reader for one socket.

    Re-entrant means a ``socket.timeout`` mid-frame leaves the partial
    bytes (and the already-parsed length) buffered, so the next call
    resumes exactly where it stopped — the client's heartbeat loop
    leans on this. ``recv_frame`` returns ``None`` only on EOF at a
    frame boundary; EOF inside a frame raises :class:`TornFrame`, and
    a length prefix past ``max_frame`` raises ``ValueError`` before a
    single payload byte is read or allocated.
    """

    def __init__(self, sock: socket.socket,
                 max_frame: int = MAX_FRAME) -> None:
        self._sock = sock
        self._buf = bytearray()
        self._need: Optional[int] = None  # parsed length of a pending frame
        self.max_frame = max_frame

    def _recv_exact(self, n: int) -> Optional[bytes]:
        """n buffered bytes; None on EOF with an EMPTY buffer (clean
        boundary), TornFrame on EOF with partial bytes."""
        while len(self._buf) < n:
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                if not self._buf:
                    return None
                raise TornFrame(
                    f"EOF mid-read ({len(self._buf)}/{n} bytes)")
            self._buf += chunk
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def read_preamble(self) -> Optional[str]:
        """Consume a ``JET-HOST <name>\\n`` preamble if the stream
        opens with one; returns the host name, or None (leaving the
        buffer untouched) when the first bytes are a frame instead."""
        k = len(PREAMBLE)
        while len(self._buf) < k:
            # stop early the moment the prefix diverges — a frame's
            # length header must not be held hostage to 9 bytes
            if self._buf and not PREAMBLE.startswith(bytes(self._buf)):
                return None
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                return None
            self._buf += chunk
        if bytes(self._buf[:k]) != PREAMBLE:
            return None
        while b"\n" not in self._buf:
            if len(self._buf) > k + MAX_PREAMBLE:
                raise ValueError("unterminated JET-HOST preamble")
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                raise TornFrame("EOF inside JET-HOST preamble")
            self._buf += chunk
        nl = self._buf.index(b"\n")
        host = bytes(self._buf[k:nl]).decode("utf-8", "replace").strip()
        del self._buf[:nl + 1]
        return host

    def recv_frame(self) -> Optional[bytes]:
        if self._need is None:
            head = self._recv_exact(_LEN.size)
            if head is None:
                return None
            (n,) = _LEN.unpack(head)
            if n > self.max_frame:
                raise ValueError(
                    f"frame of {n} bytes exceeds max_frame "
                    f"{self.max_frame}")
            self._need = n
        payload = self._recv_exact(self._need)
        if payload is None:
            raise TornFrame("EOF after frame header")
        self._need = None
        return payload
