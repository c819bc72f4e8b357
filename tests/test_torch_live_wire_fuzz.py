"""Seeded malformed-frame fuzz over the port's live wire surfaces (the
shapes of the reference's tests/test_wire_fuzz.py).

Four surfaces, one invariant: a malformed frame is CLASSIFIED (an error
response from a server, a taxonomy SimError from a client), never a
crashed serving loop or an unclassified exception escaping into the
worker. Corpus is seeded (random.Random(SEED)) so failures reproduce.

Frame classes (per surface as applicable): truncated varints, unknown
fields (proto3 must ACCEPT these), oversized / lying-length frames,
wrong-type fields, plain byte garbage.
"""

import http.client
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from jepsen_etcd_tpu_torch.sut.errors import SimError, ERROR_TYPES
from jepsen_etcd_tpu_torch.sut.http_gateway import serve
from jepsen_etcd_tpu_torch.runner.sim import set_current_loop
from jepsen_etcd_tpu_torch.runner.wall import WallLoop

SEED = 0xE7CD


@pytest.fixture()
def wall_loop():
    loop = WallLoop()
    set_current_loop(loop)
    yield loop
    set_current_loop(None)
    loop.shutdown()


@pytest.fixture()
def gateway_port():
    srv, state = serve()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _post_raw(port: int, path: str, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _b64key(k: str = "fuzz") -> str:
    import base64
    return base64.b64encode(k.encode()).decode()


def http_corpus(rng: random.Random) -> list[bytes]:
    valid = json.dumps({"key": _b64key(), "limit": 1}).encode()
    frames = []
    # truncated frames: valid JSON cut at random byte offsets
    for _ in range(8):
        frames.append(valid[:rng.randrange(1, len(valid))])
    # plain byte garbage
    for _ in range(8):
        frames.append(bytes(rng.randrange(256)
                            for _ in range(rng.randrange(1, 64))))
    # wrong-type fields: schema-shaped JSON with the wrong leaf types
    frames += [
        json.dumps({"key": 5}).encode(),
        json.dumps({"key": {"nested": 1}}).encode(),
        json.dumps({"key": "!!!not-base64!!!"}).encode(),
        json.dumps({"key": _b64key(), "limit": "many"}).encode(),
        json.dumps({"key": _b64key(), "range_end": 9}).encode(),
        json.dumps([1, 2, 3]).encode(),
        b"null",
    ]
    # oversized frame: a megabyte of zeros where an object belongs
    frames.append(b"0" * (1 << 20))
    return frames


def test_http_gateway_survives_malformed_frames(gateway_port):
    rng = random.Random(SEED)
    paths = ["/v3/kv/range", "/v3/kv/put", "/v3/kv/txn",
             "/v3/lease/grant", "/v3/cluster/member/add",
             "/v3/maintenance/status"]
    for frame in http_corpus(rng):
        path = rng.choice(paths)
        status, body = _post_raw(gateway_port, path, frame)
        # classified: an HTTP status with a JSON error body, never a
        # dropped connection (a handler crash would reset it)
        assert 200 <= status < 600, (path, frame[:40])
        if status >= 400:
            err = json.loads(body)
            assert "code" in err and "message" in err, (path, frame[:40])
    # unknown fields in otherwise-valid requests are accepted
    status, _ = _post_raw(
        gateway_port, "/v3/kv/range",
        json.dumps({"key": _b64key(), "bogus_field": 1,
                    "another": {"deep": True}}).encode())
    assert status == 200
    # the serving loop is still healthy: a well-formed request succeeds
    status, body = _post_raw(gateway_port, "/v3/kv/range",
                             json.dumps({"key": _b64key()}).encode())
    assert status == 200
    assert "header" in json.loads(body)


def test_http_gateway_fuzz_through_net_proxy(gateway_port):
    """The same malformed-frame corpus routed THROUGH the userspace
    proxy plane (net/), on both leg kinds: the client-kind leg must be
    a transparent splice, and the peer-kind leg's attribution sniffer
    must classify-or-pass garbage first bytes — never wedge a
    connection or crash a pump thread."""
    from jepsen_etcd_tpu_torch.net.plane import NetPlane
    plane = NetPlane(seed=SEED)
    ports = [plane.front("n1", "client", gateway_port),
             plane.front("n1", "peer", gateway_port)]
    try:
        rng = random.Random(SEED)
        paths = ["/v3/kv/range", "/v3/kv/put", "/v3/kv/txn",
                 "/v3/lease/grant", "/v3/maintenance/status"]
        for frame in http_corpus(rng):
            for port in ports:
                status, body = _post_raw(port, rng.choice(paths), frame)
                assert 200 <= status < 600, (port, frame[:40])
                if status >= 400:
                    err = json.loads(body)
                    assert "code" in err and "message" in err
        # both proxied legs still healthy for a well-formed request
        for port in ports:
            status, body = _post_raw(
                port, "/v3/kv/range",
                json.dumps({"key": _b64key()}).encode())
            assert status == 200
            assert "header" in json.loads(body)
    finally:
        plane.close()


# ---- native-gRPC gateway ---------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def grpc_corpus(rng: random.Random, valid: bytes) -> list[bytes]:
    frames = []
    # truncated varints / truncated messages
    for _ in range(6):
        frames.append(valid[:rng.randrange(1, max(2, len(valid)))])
    frames.append(b"\x0a\xff")              # length varint cut short
    frames.append(b"\xff\xff\xff\xff")      # tag garbage
    # lying length prefix: field 1 claims 1 GiB of bytes follow
    frames.append(b"\x0a" + _varint(1 << 30))
    # wrong wire type: field 1 (bytes, wiretype 2) sent as varint
    frames.append(b"\x08\x05")
    # byte garbage
    for _ in range(6):
        frames.append(bytes(rng.randrange(256)
                            for _ in range(rng.randrange(1, 48))))
    return frames


def test_grpc_gateway_survives_malformed_frames():
    grpc = pytest.importorskip("grpc")
    from jepsen_etcd_tpu_torch.sut.grpc_gateway import serve_grpc
    from jepsen_etcd_tpu_torch.client.proto import etcd_rpc_pb2 as pb
    from jepsen_etcd_tpu_torch.client.etcd_grpc import classify_grpc_error

    srv, _state, port = serve_grpc()
    try:
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        raw_range = chan.unary_unary(
            "/etcdserverpb.KV/Range",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        rng = random.Random(SEED)
        valid = pb.RangeRequest(key=b"fuzz", limit=1).SerializeToString()
        for frame in grpc_corpus(rng, valid):
            try:
                raw_range(frame, timeout=10)
            except grpc.RpcError as e:
                # classified into the taxonomy, like any live-client
                # error path would see it
                err = classify_grpc_error(e)
                assert err.type in ERROR_TYPES, frame
        # unknown fields are proto3-legal: parsed, ignored, served
        with_unknown = valid + b"\xf8\x07\x01"  # field 127, varint 1
        resp = pb.RangeResponse.FromString(
            raw_range(with_unknown, timeout=10))
        assert resp.header.revision >= 0
        # serving loop still healthy for a well-formed frame
        resp = pb.RangeResponse.FromString(raw_range(valid, timeout=10))
        assert resp.header.revision >= 0
        chan.close()
    finally:
        srv.stop(0)


# ---- HTTP client against a garbage server ----------------------------------

class _GarbageHandler(BaseHTTPRequestHandler):
    """Replays a scripted wire response per request."""
    script: list = []  # (mode, status, body) tuples, popped per request
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        with self.lock:
            mode, status, body = (self.script.pop(0) if self.script
                                  else ("ok", 200, b"{}"))
        if mode == "close":
            # connection dropped before any status line
            self.connection.close()
            return
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_http_client_classifies_garbage_responses(wall_loop):
    from jepsen_etcd_tpu_torch.client.etcd_http import HttpEtcdClient

    rng = random.Random(SEED)
    garbage = [
        ("body", 200, b"this is not json"),
        ("body", 200, b'{"kvs": '),                   # truncated JSON
        ("body", 200, bytes(rng.randrange(256) for _ in range(40))),
        ("body", 500, b"<html>Internal Server Error</html>"),
        ("body", 503, b'{"error": "overloaded", "code": 8, '
                      b'"message": "etcdserver: too many requests"}'),
        ("body", 400, b'{"code": 11, "message": "etcdserver: mvcc: '
                      b'required revision has been compacted"}'),
        ("close", 0, b""),                            # mid-stream EOF
    ]
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _GarbageHandler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        for mode, status, body in garbage:
            _GarbageHandler.script = [(mode, status, body)]
            c = HttpEtcdClient(
                f"http://127.0.0.1:{srv.server_address[1]}")
            try:
                with pytest.raises(SimError) as ei:
                    wall_loop.run_coro(c.revision())
                # classified, in-taxonomy — never a raw urllib/json
                # exception escaping into the worker
                assert ei.value.type in ERROR_TYPES, (mode, status, body)
            finally:
                c.close()
        # specific classifications survive the wrapping
        _GarbageHandler.script = [garbage[4]]
        c = HttpEtcdClient(f"http://127.0.0.1:{srv.server_address[1]}")
        with pytest.raises(SimError) as ei:
            wall_loop.run_coro(c.revision())
        assert ei.value.type == "too-many-requests"
        c.close()
        _GarbageHandler.script = [garbage[5]]
        c = HttpEtcdClient(f"http://127.0.0.1:{srv.server_address[1]}")
        with pytest.raises(SimError) as ei:
            wall_loop.run_coro(c.revision())
        assert ei.value.type == "compacted"
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()


# ---- gRPC client against a garbage server ----------------------------------

def test_grpc_client_classifies_garbage_responses(wall_loop):
    grpc = pytest.importorskip("grpc")
    from concurrent import futures
    from jepsen_etcd_tpu_torch.client.etcd_grpc import GrpcEtcdClient

    responses = [b"\xff\xff\xff\xff", b"\x0a" + _varint(1 << 30),
                 b"not a protobuf message at all"]
    state = {"i": 0}

    def handler(request, context):
        r = responses[state["i"] % len(responses)]
        state["i"] += 1
        return r

    method = grpc.unary_unary_rpc_method_handler(
        handler,
        request_deserializer=lambda b: b,
        response_serializer=lambda b: b)
    generic = grpc.method_handlers_generic_handler(
        "etcdserverpb.KV", {"Range": method})
    srv = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    srv.add_generic_rpc_handlers((generic,))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        for _ in responses:
            c = GrpcEtcdClient(f"http://127.0.0.1:{port}")
            try:
                with pytest.raises(SimError) as ei:
                    wall_loop.run_coro(c.get("k"))
                assert ei.value.type in ERROR_TYPES
            finally:
                c.close()
    finally:
        srv.stop(0)
