"""The port's live side against the reference's, exactly.

- (i) the same request script against both packages' HTTP gateways
  gives equal status codes and equal JSON bodies, byte for byte, and
  against both gRPC gateways equal messages (serialized bytes) and
  equal error codes and details. Excluded: in the HTTP member list,
  the default member's ``clientURLs`` echo the request's ``Host``
  header, the gateway's own loopback port, which is normalized;
- (ii) each package's clients against the other's gateways run the
  register client's op shapes with the results its own pairing gives;
- (iii) one recorded live run's ``history.jsonl`` checked by the port
  (``device="cpu"``) and by the reference gives equal workload dicts,
  on the native DFS and with ``force_kernel`` (the reference's Pallas
  batch in interpret mode);
- (vi) ``LocalDb``'s argv for the same opts equals the reference's;
- (vii) the proxy plane's seeded drop and jitter draws equal the
  reference's.

(iv) and (v) (``test.json``, ``fault_matrix`` and the refusals) are in
tests/test_torch_test_json.py and tests/test_torch_runner.py."""

import http.client
import json
import os
import sys
import threading

import pytest

grpc = pytest.importorskip("grpc")

from jepsen_etcd_tpu.client.etcd_grpc import GrpcEtcdClient as RefGrpc
from jepsen_etcd_tpu.client.etcd_http import HttpEtcdClient as RefHttp
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.history import columns_of as ref_columns_of
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.db.local import LocalDb as RefLocalDb
from jepsen_etcd_tpu.net.plane import NetPlane as RefNetPlane
from jepsen_etcd_tpu.net.proxy import LinkProxy as RefLinkProxy
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import sim as ref_sim
from jepsen_etcd_tpu.runner.wall import WallLoop as RefWallLoop
from jepsen_etcd_tpu.sut import grpc_gateway as ref_grpc_gw
from jepsen_etcd_tpu.sut import http_gateway as ref_http_gw
from jepsen_etcd_tpu.workloads import workloads as ref_workloads
from jepsen_etcd_tpu_torch import cli
from jepsen_etcd_tpu_torch.client.etcd_grpc import GrpcEtcdClient
from jepsen_etcd_tpu_torch.client.etcd_http import HttpEtcdClient, _key64
from jepsen_etcd_tpu_torch.client.proto import etcd_rpc_pb2 as pb
from jepsen_etcd_tpu_torch.core.history import History, columns_of
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.db.local import LocalDb
from jepsen_etcd_tpu_torch.generators import independent, limit
from jepsen_etcd_tpu_torch.net.plane import NetPlane
from jepsen_etcd_tpu_torch.net.proxy import LinkProxy
from jepsen_etcd_tpu_torch.runner import sim
from jepsen_etcd_tpu_torch.runner.wall import WallLoop
from jepsen_etcd_tpu_torch.sut import grpc_gateway, http_gateway
from jepsen_etcd_tpu_torch.workloads import register as register_workload
from jepsen_etcd_tpu_torch.workloads import workloads
from test_torch_fixtures import one_torch_thread  # noqa: F401

#: each package's pieces, by the name the tests parametrize over
PKG = {
    "ref": {"http_gw": ref_http_gw, "grpc_gw": ref_grpc_gw,
            "http": RefHttp, "grpc": RefGrpc, "loop": RefWallLoop,
            "sim": ref_sim},
    "port": {"http_gw": http_gateway, "grpc_gw": grpc_gateway,
             "http": HttpEtcdClient, "grpc": GrpcEtcdClient,
             "loop": WallLoop, "sim": sim},
}


class HttpGateway:
    """One package's HTTP gateway on an ephemeral loopback port."""

    def __init__(self, pkg: str):
        self.srv, self.state = PKG[pkg]["http_gw"].serve()
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.srv.server_address[1]
        self.endpoint = f"http://127.0.0.1:{self.port}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


class GrpcGateway:
    def __init__(self, pkg: str):
        self.srv, self.state, self.port = PKG[pkg]["grpc_gw"].serve_grpc()
        self.endpoint = f"http://127.0.0.1:{self.port}"

    def close(self):
        self.srv.stop(0)


GATEWAYS = {"http": HttpGateway, "grpc": GrpcGateway}


# ---- (i) one request script, both gateways ---------------------------------

def _put(key, value, lease=0):
    req = {"key": _key64(key),
           "value": _key64(json.dumps(value))}
    if lease:
        req["lease"] = str(lease)
    return {"request_put": req}


def _get(key):
    return {"request_range": {"key": _key64(key)}}


#: (path, body): put/get, CAS txns both ways, a delete, range with
#: range_end and limit, a lease with a leased key through revoke, a
#: lock, compaction (and below the horizon), a watch cancelled by the
#: compaction, status, members, defragment, and malformed requests
HTTP_SCRIPT = [
    ("/v3/kv/range", {"key": _key64("k")}),
    ("/v3/kv/txn", {"success": [_put("k", {"a": [1, 2]})]}),
    ("/v3/kv/range", {"key": _key64("k")}),
    ("/v3/kv/txn", {"compare": [{"key": _key64("k"), "target": "VALUE",
                                 "result": "EQUAL",
                                 "value": _key64(json.dumps({"a": [1, 2]}))}],
                    "success": [_get("k"), _put("k", 2)],
                    "failure": [_get("k")]}),
    ("/v3/kv/txn", {"compare": [{"key": _key64("k"), "target": "VALUE",
                                 "result": "EQUAL",
                                 "value": _key64(json.dumps({"a": [1, 2]}))}],
                    "success": [_put("k", 3)], "failure": [_get("k")]}),
    ("/v3/kv/txn", {"compare": [{"key": _key64("k"), "target": "VERSION",
                                 "result": "EQUAL", "version": "2"}],
                    "success": [_put("k", 4)], "failure": []}),
    ("/v3/kv/txn", {"compare": [{"key": _key64("k"), "target": "MOD",
                                 "result": "LESS", "mod_revision": "1"}],
                    "success": [], "failure": [_get("k")]}),
] + [("/v3/kv/txn", {"success": [_put(f"pfx/{i}", i)]}) for i in range(5)] + [
    ("/v3/kv/txn", {"success": [_put("zzz", 99)]}),
    ("/v3/kv/txn", {"success": [
        {"request_delete_range": {"key": _key64("pfx/2")}}]}),
    ("/v3/kv/range", {"key": _key64("pfx/"), "range_end": _key64("pfx0")}),
    ("/v3/kv/range", {"key": _key64("pfx/"), "range_end": _key64("pfx0"),
                      "limit": 2}),
    ("/v3/kv/range", {"key": _key64("pfx/3"),
                      "range_end": _key64("\x00")}),
    ("/v3/lease/grant", {"TTL": 5}),
    ("/v3/lease/keepalive", {"ID": "4097"}),
    ("/v3/kv/txn", {"success": [_put("leased", 1, lease=4097)]}),
    ("/v3/lock/lock", {"name": _key64("lk"), "lease": "4097"}),
    ("/v3/kv/range", {"key": _key64("lk/"), "range_end": _key64("lk0")}),
    ("/v3/lock/unlock", {"key": _key64("lk/0000000000001001")}),
    ("/v3/lease/revoke", {"ID": "4097"}),
    ("/v3/kv/range", {"key": _key64("leased")}),
    ("/v3/lease/revoke", {"ID": "4097"}),
    ("/v3/lease/keepalive", {"ID": "4097"}),
    ("/v3/kv/compaction", {"revision": 10}),
    ("/v3/kv/compaction", {"revision": 4}),
    ("/v3/watch", {"create_request": {"key": _key64("k"),
                                      "start_revision": 2}}),
    ("/v3/maintenance/status", {}),
    ("/v3/cluster/member/list", {}),
    ("/v3/cluster/member/add", {"peerURLs": ["http://127.0.0.1:7001"]}),
    ("/v3/cluster/member/add", {"peerURLs": ["http://127.0.0.1:7001"]}),
    ("/v3/cluster/member/remove", {"ID": "12345"}),
    ("/v3/maintenance/defragment", {}),
    ("/v3/kv/range", {}),
    ("/v3/nope", {}),
]


def _http_replies(gw) -> list:
    out = []
    for path, body in HTTP_SCRIPT + [("/v3/kv/range", None)]:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
        try:
            data = b"{not json" if body is None else \
                json.dumps(body).encode()
            conn.request("POST", path, body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            try:
                raw = resp.read().decode()
            except http.client.IncompleteRead as e:
                # a cancelled watch stream ends without the last chunk
                raw = e.partial.decode()
        finally:
            conn.close()
        # the default member's clientURLs echo the Host header
        raw = raw.replace(f"127.0.0.1:{gw.port}", "127.0.0.1:PORT")
        out.append((path, resp.status, raw))
    return out


def test_http_gateway_replies_equal_the_references():
    replies = {}
    for pkg in ("ref", "port"):
        gw = HttpGateway(pkg)
        try:
            replies[pkg] = _http_replies(gw)
        finally:
            gw.close()
    assert len(replies["port"]) == len(HTTP_SCRIPT) + 1
    for got, want in zip(replies["port"], replies["ref"]):
        assert got == want
    # the script reached every branch it names: successes and errors
    statuses = {s for _, s, _ in replies["port"]}
    assert {200, 400, 404} <= statuses
    watch = [r for p, _, r in replies["port"] if p == "/v3/watch"][0]
    assert '"canceled": true' in watch and '"compact_revision": "10"' \
        in watch


def _unary(channel, path, req_cls, resp_cls):
    return channel.unary_unary(path,
                               request_serializer=req_cls.SerializeToString,
                               response_deserializer=resp_cls.FromString)


#: (method path, request, response class)
GRPC_SCRIPT = [
    ("/etcdserverpb.KV/Range", pb.RangeRequest(key=b"k"),
     pb.RangeResponse),
    ("/etcdserverpb.KV/Txn", pb.TxnRequest(success=[pb.RequestOp(
        request_put=pb.PutRequest(key=b"k", value=b'{"a": [1, 2]}'))]),
     pb.TxnResponse),
    ("/etcdserverpb.KV/Range", pb.RangeRequest(key=b"k"),
     pb.RangeResponse),
    ("/etcdserverpb.KV/Txn", pb.TxnRequest(
        compare=[pb.Compare(key=b"k", target=pb.Compare.VALUE,
                            result=pb.Compare.EQUAL,
                            value=b'{"a": [1, 2]}')],
        success=[pb.RequestOp(request_range=pb.RangeRequest(key=b"k")),
                 pb.RequestOp(request_put=pb.PutRequest(key=b"k",
                                                        value=b"2"))],
        failure=[pb.RequestOp(request_range=pb.RangeRequest(key=b"k"))]),
     pb.TxnResponse),
    ("/etcdserverpb.KV/Txn", pb.TxnRequest(
        compare=[pb.Compare(key=b"k", target=pb.Compare.VALUE,
                            result=pb.Compare.EQUAL,
                            value=b'{"a": [1, 2]}')],
        success=[pb.RequestOp(request_put=pb.PutRequest(key=b"k",
                                                        value=b"3"))],
        failure=[pb.RequestOp(request_range=pb.RangeRequest(key=b"k"))]),
     pb.TxnResponse),
    ("/etcdserverpb.KV/Txn", pb.TxnRequest(
        compare=[pb.Compare(key=b"k", target=pb.Compare.VERSION,
                            result=pb.Compare.EQUAL, version=2)],
        success=[pb.RequestOp(request_put=pb.PutRequest(key=b"k",
                                                        value=b"4"))]),
     pb.TxnResponse),
] + [
    ("/etcdserverpb.KV/Txn", pb.TxnRequest(success=[pb.RequestOp(
        request_put=pb.PutRequest(key=f"pfx/{i}".encode(),
                                  value=str(i).encode()))]),
     pb.TxnResponse) for i in range(5)
] + [
    ("/etcdserverpb.KV/Txn", pb.TxnRequest(success=[pb.RequestOp(
        request_delete_range=pb.DeleteRangeRequest(key=b"pfx/2"))]),
     pb.TxnResponse),
    ("/etcdserverpb.KV/Range", pb.RangeRequest(key=b"pfx/",
                                               range_end=b"pfx0"),
     pb.RangeResponse),
    ("/etcdserverpb.KV/Range", pb.RangeRequest(key=b"pfx/",
                                               range_end=b"pfx0", limit=2),
     pb.RangeResponse),
    ("/etcdserverpb.KV/Range", pb.RangeRequest(key=b"pfx/3",
                                               range_end=b"\x00"),
     pb.RangeResponse),
    ("/etcdserverpb.Lease/LeaseGrant", pb.LeaseGrantRequest(TTL=5),
     pb.LeaseGrantResponse),
    ("/etcdserverpb.KV/Txn", pb.TxnRequest(success=[pb.RequestOp(
        request_put=pb.PutRequest(key=b"leased", value=b"1",
                                  lease=4097))]),
     pb.TxnResponse),
    ("/v3lockpb.Lock/Lock", pb.LockRequest(name=b"lk", lease=4097),
     pb.LockResponse),
    ("/v3lockpb.Lock/Unlock", pb.UnlockRequest(key=b"lk/0000000000001001"),
     pb.UnlockResponse),
    ("/etcdserverpb.Lease/LeaseRevoke", pb.LeaseRevokeRequest(ID=4097),
     pb.LeaseRevokeResponse),
    ("/etcdserverpb.KV/Range", pb.RangeRequest(key=b"leased"),
     pb.RangeResponse),
    ("/etcdserverpb.Lease/LeaseRevoke", pb.LeaseRevokeRequest(ID=4097),
     pb.LeaseRevokeResponse),
    ("/etcdserverpb.KV/Compact", pb.CompactionRequest(revision=10),
     pb.CompactionResponse),
    ("/etcdserverpb.KV/Compact", pb.CompactionRequest(revision=4),
     pb.CompactionResponse),
    ("/etcdserverpb.Maintenance/Status", pb.StatusRequest(),
     pb.StatusResponse),
    ("/etcdserverpb.Cluster/MemberList", pb.MemberListRequest(),
     pb.MemberListResponse),
    ("/etcdserverpb.Cluster/MemberAdd",
     pb.MemberAddRequest(peerURLs=["http://127.0.0.1:7001"]),
     pb.MemberAddResponse),
    ("/etcdserverpb.Cluster/MemberAdd",
     pb.MemberAddRequest(peerURLs=["http://127.0.0.1:7001"]),
     pb.MemberAddResponse),
    ("/etcdserverpb.Cluster/MemberRemove", pb.MemberRemoveRequest(ID=1),
     pb.MemberRemoveResponse),
    ("/etcdserverpb.Maintenance/Defragment", pb.DefragmentRequest(),
     pb.DefragmentResponse),
]


def _grpc_replies(gw) -> list:
    out = []
    with grpc.insecure_channel(f"127.0.0.1:{gw.port}") as ch:
        for path, req, resp_cls in GRPC_SCRIPT:
            call = _unary(ch, path, type(req), resp_cls)
            try:
                resp = call(req, timeout=10)
                out.append((path, "OK",
                            resp.SerializeToString(deterministic=True)))
            except grpc.RpcError as e:
                out.append((path, e.code().name, e.details()))
        # a watch below the compaction horizon: created, then cancelled
        # with the horizon
        watch = ch.stream_stream(
            "/etcdserverpb.Watch/Watch",
            request_serializer=pb.WatchRequest.SerializeToString,
            response_deserializer=pb.WatchResponse.FromString)
        stop = threading.Event()

        def reqs():
            yield pb.WatchRequest(create_request=pb.WatchCreateRequest(
                key=b"k", start_revision=2))
            stop.wait(10)

        call = watch(reqs(), timeout=10)
        try:
            for resp in call:
                out.append(("watch", "OK",
                            resp.SerializeToString(deterministic=True)))
                if resp.canceled:
                    break
        finally:
            stop.set()
            call.cancel()
    return out


def test_grpc_gateway_replies_equal_the_references():
    replies = {}
    for pkg in ("ref", "port"):
        gw = GrpcGateway(pkg)
        try:
            replies[pkg] = _grpc_replies(gw)
        finally:
            gw.close()
    assert len(replies["port"]) == len(GRPC_SCRIPT) + 2
    for got, want in zip(replies["port"], replies["ref"]):
        assert got == want
    codes = {c for _, c, _ in replies["port"]}
    assert {"OK", "NOT_FOUND", "OUT_OF_RANGE", "ALREADY_EXISTS"} <= codes
    last = pb.WatchResponse.FromString(replies["port"][-1][2])
    assert last.canceled and last.compact_revision == 10


# ---- (ii) each package's clients against the other's gateways --------------

async def _register_ops(c) -> list:
    """The register client's op shapes: write with prev-kv, read,
    value-CAS that wins and one that loses, read."""
    return [await c.put("r0", 3), await c.get("r0"),
            await c.cas("r0", 3, 4), await c.cas("r0", 3, 5),
            await c.get("r0"), await c.revision()]


def _drive(client_pkg: str, wire: str, endpoint: str) -> list:
    p = PKG[client_pkg]
    loop = p["loop"]()
    p["sim"].set_current_loop(loop)
    try:
        c = p[wire](endpoint)
        try:
            return json.loads(json.dumps(loop.run_coro(_register_ops(c)),
                                         sort_keys=True))
        finally:
            c.close()
    finally:
        p["sim"].set_current_loop(None)
        loop.shutdown()


def _pairing(client_pkg, gw_pkg, wire) -> list:
    gw = GATEWAYS[wire](gw_pkg)
    try:
        return _drive(client_pkg, wire, gw.endpoint)
    finally:
        gw.close()


@pytest.mark.parametrize("wire", ["http", "grpc"])
@pytest.mark.parametrize("client_pkg,gw_pkg", [("port", "ref"),
                                               ("ref", "port")])
def test_clients_interoperate_with_the_references(wire, client_pkg,
                                                  gw_pkg):
    want = _pairing("ref", "ref", wire)
    got = _pairing(client_pkg, gw_pkg, wire)
    assert got == want
    assert got == _pairing("port", "port", wire)
    assert want[1]["value"] == 3 and want[2]["succeeded"] is True
    assert want[3]["succeeded"] is False and want[4]["value"] == 4


# ---- (iii) a recorded live run, checked by both packages -------------------

#: keys the recorded run works, all of them to their 20 ops
RECORDED_KEYS = 12


class _RecordedKeys:
    """The register workload's ``independent``, its key range cut to
    the first ``RECORDED_KEYS`` keys."""

    def concurrent_generator(self, n, keys, gen_fn):
        return independent.concurrent_generator(n, keys[:RECORDED_KEYS],
                                                gen_fn)


class _CutKey:
    """``_RecordedKeys``, then one more key cut after its first op, a
    write, as a time limit cuts a run's last key."""

    def concurrent_generator(self, n, keys, gen_fn):
        cut = keys[RECORDED_KEYS]
        return independent.concurrent_generator(
            n, keys[:RECORDED_KEYS + 1],
            lambda k: limit(1, register_workload.w) if k == cut
            else gen_fn(k))


def _record_live(tmp_path_factory, keys) -> tuple:
    """(history.jsonl text, results.json) of a live register run over
    the port's HTTP gateway, its keys drawn through ``keys`` (the
    register workload's ``independent``, patched)."""
    gw = HttpGateway("port")
    store = tmp_path_factory.mktemp("live")
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(register_workload, "independent", keys)
            rc = cli.main(["test", "-w", "register", "--client-type",
                           "http", "--endpoint", gw.endpoint,
                           "--time-limit", "6", "-r", "200", "-c", "4",
                           "--ops-per-key", "20", "--store", str(store),
                           "--device", "cpu"])
    finally:
        gw.close()
    assert rc == 0
    run_dir = [r for r, _, fs in os.walk(store) if "results.json" in fs][0]
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        text = f.read()
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    return text, results


@pytest.fixture(scope="module")
def recorded_live_run(tmp_path_factory):
    """A live run whose every key is worked to its 20 ops well inside
    the time limit (240 ops at rate 200: ~1.2 s of 6). A key cut by the
    time limit can hold one lone op: a failed CAS, which needs no
    search and so names no engine, or a write with no read, whose
    session write count the reference gives as 1 on the run's
    column-backed history and 0 on the same history re-read from
    history.jsonl. No package can then give a re-check equal both to
    the reference's and to the stored dict, so the cut key has tests of
    its own below (``recorded_cut_run``, ``CUT_OPS``)."""
    return _record_live(tmp_path_factory, _RecordedKeys())


@pytest.fixture(scope="module")
def recorded_cut_run(tmp_path_factory):
    """A live run of ``RECORDED_KEYS`` keys worked to their 20 ops and
    one key cut to a lone write (``_CutKey``)."""
    return _record_live(tmp_path_factory, _CutKey())


@pytest.mark.parametrize("force_kernel", [False, True],
                         ids=["native-dfs", "force-kernel"])
def test_recorded_live_history_checks_equal(recorded_live_run,
                                            force_kernel, monkeypatch):
    text, results = recorded_live_run
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    opts = {"ops_per_key": 20, "force_kernel": force_kernel,
            "nodes": ["n1"]}
    port = workloads()["register"](dict(opts, device="cpu"))["checker"] \
        .check({}, History.from_jsonl(text), {})
    ref = ref_workloads()["register"](dict(opts))["checker"] \
        .check({}, RefHistory.from_jsonl(text), {})

    def as_json(x):
        return json.loads(json.dumps(x, default=repr, sort_keys=True))
    assert as_json(port) == as_json(ref)
    assert port["valid?"] is True and len(port["results"]) >= 2
    engines = {r["linear"].get("engine") for r in port["results"].values()}
    if force_kernel:
        assert engines == {"mxu-wave"}
    else:
        # the recorded run's own (default-routed) dict, re-read
        assert as_json(port) == as_json(results["workload"])
        assert "mxu-wave" not in engines


# ---- (iii) a key cut to a lone write: stored and re-checked dicts ----------

#: a fixed recorded history in a live register run's shape: key 0 worked
#: (a write, a read, a failed CAS), key 1 cut after its first op, a write
CUT_OPS = [dict(op, time=1_000_000 * t) for t, op in enumerate([
    {"type": "invoke", "process": 0, "f": "write", "value": (0, [None, 2])},
    {"type": "ok", "process": 0, "f": "write", "value": (0, [1, 2])},
    {"type": "invoke", "process": 1, "f": "read", "value": (0, [None, None])},
    {"type": "ok", "process": 1, "f": "read", "value": (0, [1, 2])},
    {"type": "invoke", "process": 0, "f": "cas",
     "value": (0, [None, [4, 0]])},
    {"type": "fail", "process": 0, "f": "cas", "value": (0, [None, [4, 0]]),
     "error": "did-not-succeed"},
    {"type": "invoke", "process": 2, "f": "write", "value": (1, [None, 3])},
    {"type": "ok", "process": 2, "f": "write", "value": (1, [1, 3])},
])]


def differences(a, b, path=()) -> list:
    """(path, a's value, b's value) of every leaf where two JSON values
    differ, in key order."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            out += differences(a.get(k), b.get(k), path + (k,))
        return out
    return [] if a == b else [(path, a, b)]


def _recheck(text, force_kernel) -> tuple:
    """(port's, reference's) register dicts on history.jsonl ``text``,
    re-read as the live-parity test reads it."""
    opts = {"ops_per_key": 20, "force_kernel": force_kernel,
            "nodes": ["n1"]}
    port = workloads()["register"](dict(opts, device="cpu"))["checker"] \
        .check({}, History.from_jsonl(text), {})
    ref = ref_workloads()["register"](dict(opts))["checker"] \
        .check({}, RefHistory.from_jsonl(text), {})
    return as_json(port), as_json(ref)


def as_json(x):
    return json.loads(json.dumps(x, default=repr, sort_keys=True))


@pytest.mark.parametrize("force_kernel", [False, True],
                         ids=["native-dfs", "force-kernel"])
def test_cut_key_differs_only_in_session_writes(force_kernel,
                                                monkeypatch):
    """The live-parity comparison on ``CUT_OPS``: each package's dict on
    the history as a run records it (dicts and columns) is the stored
    verdict, its dict on the history.jsonl re-read the re-check. The two
    packages agree on both; the two differ in the cut key's session
    write count alone (1 stored, 0 re-checked), in both packages."""
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    opts = {"ops_per_key": 20, "force_kernel": force_kernel,
            "nodes": ["n1"]}
    ops = History([Op(o) for o in CUT_OPS]).ops
    ref_ops = RefHistory([RefOp(o) for o in CUT_OPS]).ops
    assert columns_of(ops) is not None
    stored = as_json(workloads()["register"](dict(opts, device="cpu"))
                     ["checker"].check({}, History(ops, columns_of(ops)),
                                       {}))
    ref_stored = as_json(ref_workloads()["register"](dict(opts))["checker"]
                         .check({}, RefHistory(ref_ops,
                                               ref_columns_of(ref_ops)),
                                {}))
    text = History(ops).to_jsonl()
    assert text == RefHistory(ref_ops).to_jsonl()
    port, ref = _recheck(text, force_kernel)
    assert stored == ref_stored
    assert port == ref
    assert differences(stored, port) == [
        (("results", "1", "session", "writes"), 1, 0)]


@pytest.mark.parametrize("force_kernel", [False, True],
                         ids=["native-dfs", "force-kernel"])
def test_chip_smoke_reread_hold_lets_c6_alone_pass(force_kernel):
    """``chip_smoke.reread_differences``, the live runs' hold of the
    stored dict against history.jsonl re-read, on ``CUT_OPS``: C6's
    session write count of the cut key (no read) passes; the same
    difference on key 0, which has a read, fails."""
    import chip_smoke
    ops = History([Op(o) for o in CUT_OPS]).ops
    history = History(ops, columns_of(ops))
    checker = workloads()["register"](
        {"ops_per_key": 20, "force_kernel": force_kernel, "nodes": ["n1"],
         "device": "cpu"})["checker"]
    stored = checker.check({}, history, {})
    reread = checker.check({}, History.from_jsonl(history.to_jsonl()), {})
    subs = history.split_by_key()
    assert chip_smoke.reread_differences(stored, reread, subs) == (
        True, [(("results", "1", "session", "writes"), 1, 0)])
    key0 = [k for k in stored["results"] if str(k) == "0"][0]
    stored["results"][key0]["session"]["writes"] += 1
    ok, diffs = chip_smoke.reread_differences(stored, reread, subs)
    assert not ok and (("results", "0", "session", "writes"), 2, 1) in diffs


def test_recorded_cut_key_differs_only_in_session_writes(recorded_cut_run):
    """``recorded_cut_run`` (its last key cut to a lone write) through
    the live-parity comparison: the port's re-check of history.jsonl
    equals the reference's, and differs from the stored results.json in
    the cut key's session write count alone."""
    text, results = recorded_cut_run
    port, ref = _recheck(text, False)
    assert port == ref
    assert port["valid?"] is True
    assert len(port["results"]) == RECORDED_KEYS + 1
    cut = str(max(map(int, port["results"])))
    assert differences(as_json(results["workload"]), port) == [
        (("results", cut, "session", "writes"), 1, 0)]


# ---- (vi) the local control plane's argv -----------------------------------

@pytest.mark.parametrize("extra", [
    {},
    {"unsafe_no_fsync": True, "corrupt_check": True, "snapshot_count": 77},
    {"etcd_binary": "/usr/local/bin/etcd --enable-v2=false"},
], ids=["defaults", "knobs", "binary"])
def test_local_db_argv_equals_the_references(tmp_path, extra):
    nodes = ["n1", "n2", "n3"]
    opts = dict({"etcd_binary": "fake", "nodes": nodes,
                 "etcd_data_dir": str(tmp_path / "data"),
                 "client_type": "http"}, **extra)
    ports = {n: (20000 + i, 21000 + i) for i, n in enumerate(nodes)}
    argvs = {}
    for name, cls in (("ref", RefLocalDb), ("port", LocalDb)):
        db = cls(dict(opts))
        db.ports = dict(ports)
        argvs[name] = [db._argv(n, "new", nodes) for n in nodes]
        db.stop_all()
    for got, want in zip(argvs["port"], argvs["ref"]):
        if "etcd_binary" in extra:
            assert got == want
        else:
            # [python, <each package's fake_etcd.py>, flags...]
            assert got[0] == want[0] == sys.executable
            assert got[1].endswith(os.path.join("jepsen_etcd_tpu_torch",
                                                "db", "fake_etcd.py"))
            assert got[2:] == want[2:]


# ---- (vii) the proxy plane's seeded draws ----------------------------------

class _Sink:
    def __init__(self):
        self.chunks = []

    def sendall(self, data):
        self.chunks.append(data)


def _draws(plane_cls, proxy_cls, seed, p, n=96) -> tuple:
    plane = plane_cls(seed=seed)
    plane.set_drop_prob(p)
    proxy = proxy_cls("n1", "client", target_port=1, router=plane.route,
                      jitter=plane._jitter)
    try:
        sink, state, passed = _Sink(), {}, []
        for i in range(n):
            before = len(sink.chunks)
            proxy._forward(b"chunk-%d" % i, sink, "client", "n1", state)
            passed.append(len(sink.chunks) > before)
        jitter = [plane._jitter() for _ in range(16)]
        return passed, jitter
    finally:
        proxy.close()
        plane.close()


@pytest.mark.parametrize("seed,p", [(0, 0.5), (7, 0.05), (11, 0.9)])
def test_plane_drop_draws_equal_the_references(seed, p):
    got = _draws(NetPlane, LinkProxy, seed, p)
    want = _draws(RefNetPlane, RefLinkProxy, seed, p)
    assert got == want
    assert any(got[0]) and not all(got[0])


def test_pb2_descriptor_is_the_references():
    """The port's pb2 carries the reference's descriptor byte for byte
    (same file name and package), so both load in one process."""
    from jepsen_etcd_tpu.client.proto import etcd_rpc_pb2 as ref_pb
    assert pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.name == "etcd_rpc.proto"
    assert pb.DESCRIPTOR.package == "etcdwire"
