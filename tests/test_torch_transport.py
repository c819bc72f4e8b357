"""Frame robustness of the port's transport
(``jepsen_etcd_tpu_torch/runner/transport.py``, a copy of the
reference's; the cases of ``tests/test_transport.py``, JAX-free): the
reader must tell a peer that finished (clean EOF -> None) from a link
that died mid-frame (TornFrame), reject absurd length prefixes BEFORE
allocating, survive socket timeouts mid-frame (re-entrancy), and parse
— or decline — the JET-HOST preamble without eating frame bytes.
"""

import socket
import struct

import pytest

from jepsen_etcd_tpu_torch.runner import transport
from jepsen_etcd_tpu_torch.runner.transport import (
    FrameReader, TornFrame, send_frame, send_preamble)


def pair():
    a, b = socket.socketpair()
    return a, b


def test_roundtrip_frames():
    a, b = pair()
    try:
        send_frame(a, b"hello")
        send_frame(a, b"")
        send_frame(a, b"x" * 70000)  # > one recv chunk
        r = FrameReader(b)
        assert r.recv_frame() == b"hello"
        assert r.recv_frame() == b""
        assert r.recv_frame() == b"x" * 70000
    finally:
        a.close()
        b.close()


def test_clean_eof_is_none():
    a, b = pair()
    try:
        send_frame(a, b"last")
        a.close()
        r = FrameReader(b)
        assert r.recv_frame() == b"last"
        assert r.recv_frame() is None  # EOF exactly on a boundary
    finally:
        b.close()


def test_torn_mid_header():
    """EOF after 3 of the 8 length bytes: the peer died mid-message,
    not finished — TornFrame, never a silent None."""
    a, b = pair()
    try:
        a.sendall(b"\x05\x00\x00")
        a.close()
        with pytest.raises(TornFrame):
            FrameReader(b).recv_frame()
    finally:
        b.close()


def test_truncated_payload():
    a, b = pair()
    try:
        a.sendall(struct.pack("<Q", 100) + b"only-ten-b")
        a.close()
        with pytest.raises(TornFrame):
            FrameReader(b).recv_frame()
    finally:
        b.close()


def test_absurd_length_rejected_before_allocating():
    """A corrupt/adversarial 8-byte prefix claiming an exabyte frame
    must raise from the 8 header bytes alone — the reader never tries
    to buffer (or allocate) the claimed payload."""
    a, b = pair()
    try:
        a.sendall(struct.pack("<Q", 1 << 60))  # no payload follows
        r = FrameReader(b)
        b.settimeout(5.0)  # if it tried to read the payload, it hangs
        with pytest.raises(ValueError, match="exceeds max_frame"):
            r.recv_frame()
    finally:
        a.close()
        b.close()


def test_custom_max_frame_cap():
    a, b = pair()
    try:
        send_frame(a, b"y" * 2048)
        with pytest.raises(ValueError, match="exceeds max_frame"):
            FrameReader(b, max_frame=1024).recv_frame()
    finally:
        a.close()
        b.close()


def test_reader_reentrant_across_timeouts():
    """A socket timeout mid-frame (header parsed, payload partial)
    must leave the reader resumable: the next recv_frame call picks up
    exactly where it stopped — the client heartbeat loop depends on
    this."""
    a, b = pair()
    try:
        b.settimeout(0.05)
        r = FrameReader(b)
        a.sendall(struct.pack("<Q", 6) + b"abc")  # half the payload
        with pytest.raises(socket.timeout):
            r.recv_frame()
        with pytest.raises(socket.timeout):  # still parked, still sane
            r.recv_frame()
        a.sendall(b"def")
        assert r.recv_frame() == b"abcdef"
        # and the stream keeps working after the stall
        send_frame(a, b"next")
        assert r.recv_frame() == b"next"
    finally:
        a.close()
        b.close()


def test_preamble_roundtrip_then_frames():
    a, b = pair()
    try:
        send_preamble(a, "hostB")
        send_frame(a, b"frame1")
        r = FrameReader(b)
        assert r.read_preamble() == "hostB"
        assert r.recv_frame() == b"frame1"
    finally:
        a.close()
        b.close()


def test_preamble_absent_leaves_frames_untouched():
    """A stream that opens with a frame (unix-socket clients skip the
    preamble) must not lose a single byte to the preamble probe."""
    a, b = pair()
    try:
        send_frame(a, b"no-preamble-here")
        r = FrameReader(b)
        assert r.read_preamble() is None
        assert r.recv_frame() == b"no-preamble-here"
    finally:
        a.close()
        b.close()


def test_preamble_diverging_prefix_returns_early():
    """First bytes sharing a prefix with JET-HOST but diverging must
    return None the moment they diverge, without waiting for more
    bytes (a frame length header would stall it forever otherwise)."""
    a, b = pair()
    try:
        a.sendall(b"JE")        # prefix of the preamble...
        a.sendall(b"X-rest")    # ...then divergence, no newline ever
        b.settimeout(5.0)
        r = FrameReader(b)
        assert r.read_preamble() is None
        assert bytes(r._buf) == b"JEX-rest"  # nothing consumed
    finally:
        a.close()
        b.close()


def test_preamble_unterminated_is_rejected():
    a, b = pair()
    try:
        a.sendall(transport.PREAMBLE + b"x" * 600)  # no \n, too long
        with pytest.raises(ValueError, match="unterminated"):
            FrameReader(b).read_preamble()
    finally:
        a.close()
        b.close()


def test_parse_tcp():
    assert transport.is_tcp("tcp://127.0.0.1:8000")
    assert not transport.is_tcp("/tmp/x.sock")
    assert transport.parse_tcp("tcp://10.0.0.1:99") == ("10.0.0.1", 99)
    for bad in ("tcp://", "tcp://host", "tcp://:80x", "tcp://:"):
        with pytest.raises(ValueError):
            transport.parse_tcp(bad)


def test_listen_tcp_specs():
    ls, ep = transport.listen_tcp(True)
    try:
        assert ep.startswith("tcp://127.0.0.1:")
        host, port = transport.parse_tcp(ep)
        assert port > 0
        c = transport.connect(ep, timeout=5.0)
        c.close()
    finally:
        ls.close()
