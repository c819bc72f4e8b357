"""Native-gRPC etcd v3 server over the simulated MVCC store.

The gRPC sibling of ``http_gateway.py``, sharing its ``GatewayState``
(one Store, total order via a lock). Two jobs:

- the hermetic test double for the native-gRPC client adapter
  (client/etcd_grpc.py): the adapter speaks the same frames to this
  server as to a live etcd — etcdserverpb/v3lockpb method paths,
  proto messages with etcd's field numbers, streaming watch with
  compaction-cancel framing — so the reference's actual wire protocol
  (jetcd's, client.clj:14-68) is exercised end-to-end without an etcd
  binary;
- a live etcd-wire gRPC endpoint backed by the simulated store
  (``python -m jepsen_etcd_tpu_torch gateway --grpc``): real etcd gRPC
  tooling can talk to the simulated store.

Handlers are registered generically (grpc.method_handlers_generic_
handler) against explicit method paths, so no grpc_tools service
codegen is needed.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Iterator

from .errors import SimError
from .store import Txn
from .http_gateway import GatewayState, member_id_for_peer_urls
from ..client.proto import etcd_rpc_pb2 as pb

_CMP_OP = {pb.Compare.EQUAL: "=", pb.Compare.LESS: "<",
           pb.Compare.GREATER: ">"}
_CMP_TARGET = {pb.Compare.VALUE: "value", pb.Compare.VERSION: "version",
               pb.Compare.MOD: "mod_revision",
               pb.Compare.CREATE: "create_revision"}


def _unval(b: bytes):
    try:
        return json.loads(b)
    except ValueError:
        return b.decode("utf-8", "replace")


def _kv_wire(kv: dict) -> pb.KeyValue:
    return pb.KeyValue(
        key=kv["key"].encode("utf-8"),
        value=json.dumps(kv["value"]).encode("utf-8"),
        version=int(kv["version"]),
        create_revision=int(kv["create-revision"]),
        mod_revision=int(kv["mod-revision"]),
        lease=int(kv.get("lease", 0)))


class _Services:
    """All service handlers over one shared GatewayState."""

    def __init__(self, state: GatewayState):
        self.st = state

    # ---- KV ----------------------------------------------------------------

    def range(self, req: pb.RangeRequest, ctx) -> pb.RangeResponse:
        key = req.key.decode("utf-8")
        range_end = req.range_end.decode("utf-8") if req.range_end \
            else None
        with self.st.lock:
            kvs = self.st.store.range_interval(key, range_end)
            rev = self.st.store.revision
        more = bool(req.limit) and len(kvs) > req.limit
        count = len(kvs)
        if req.limit:
            kvs = kvs[:req.limit]
        return pb.RangeResponse(
            header=pb.ResponseHeader(revision=rev),
            kvs=[_kv_wire(kv) for kv in kvs], more=more, count=count)

    def txn(self, req: pb.TxnRequest, ctx) -> pb.TxnResponse:
        cmps = []
        for c in req.compare:
            target = _CMP_TARGET[c.target]
            if target == "value":
                operand = _unval(c.value)
            elif target == "version":
                operand = int(c.version)
            elif target == "mod_revision":
                operand = int(c.mod_revision)
            else:
                operand = int(c.create_revision)
            cmps.append((_CMP_OP[c.result], c.key.decode("utf-8"),
                         target, operand))

        def branch(ops):
            out = []
            for o in ops:
                which = o.WhichOneof("request")
                if which == "request_range":
                    out.append(("get",
                                o.request_range.key.decode("utf-8")))
                elif which == "request_put":
                    p = o.request_put
                    out.append(("put", p.key.decode("utf-8"),
                                _unval(p.value), int(p.lease)))
                elif which == "request_delete_range":
                    out.append(("delete", o.request_delete_range.key
                                .decode("utf-8")))
            return out

        txn = Txn(tuple(cmps), tuple(branch(req.success)),
                  tuple(branch(req.failure)))
        with self.st.lock:
            raw = self.st.store.apply_txn(txn)
        resp = pb.TxnResponse(
            header=pb.ResponseHeader(revision=raw["revision"]),
            succeeded=raw["succeeded"])
        for r in raw["results"]:
            ro = resp.responses.add()
            if r[0] == "get":
                if r[1]:
                    ro.response_range.kvs.append(_kv_wire(r[1]))
                    ro.response_range.count = 1
                else:
                    ro.response_range.count = 0
            elif r[0] == "put":
                if r[1]:
                    ro.response_put.prev_kv.CopyFrom(_kv_wire(r[1]))
                else:
                    ro.response_put.SetInParent()
            else:
                ro.response_delete_range.deleted = int(r[1])
        return resp

    def compact(self, req: pb.CompactionRequest,
                ctx) -> pb.CompactionResponse:
        import grpc
        with self.st.lock:
            if req.revision <= self.st.store.compact_revision:
                ctx.abort(grpc.StatusCode.OUT_OF_RANGE,
                          "etcdserver: mvcc: required revision has "
                          "been compacted")
            self.st.store.compact(int(req.revision))
            return pb.CompactionResponse(header=pb.ResponseHeader(
                revision=self.st.store.revision))

    # ---- lease -------------------------------------------------------------

    def lease_grant(self, req: pb.LeaseGrantRequest,
                    ctx) -> pb.LeaseGrantResponse:
        with self.st.lock:
            self.st.next_lease += 1
            lid = self.st.next_lease
            self.st.leases[lid] = int(req.TTL) or 1
        return pb.LeaseGrantResponse(ID=lid, TTL=self.st.leases[lid])

    def lease_revoke(self, req: pb.LeaseRevokeRequest,
                     ctx) -> pb.LeaseRevokeResponse:
        import grpc
        lid = int(req.ID)
        with self.st.lock:
            if lid not in self.st.leases:
                ctx.abort(grpc.StatusCode.NOT_FOUND,
                          "etcdserver: requested lease not found")
            del self.st.leases[lid]
            for key in sorted(self.st.store.lease_keys.get(lid, ())):
                self.st.store.apply_txn(
                    Txn((), (("delete", key),), ()))
        return pb.LeaseRevokeResponse()

    def lease_keepalive(self, request_iterator: Iterator,
                        ctx) -> Iterator[pb.LeaseKeepAliveResponse]:
        for req in request_iterator:
            lid = int(req.ID)
            with self.st.lock:
                ttl = self.st.leases.get(lid, 0)
            yield pb.LeaseKeepAliveResponse(ID=lid, TTL=ttl)

    # ---- lock --------------------------------------------------------------

    def lock(self, req: pb.LockRequest, ctx) -> pb.LockResponse:
        import grpc
        name = req.name.decode("utf-8")
        lid = int(req.lease)
        my_key = f"{name}/{lid:016x}"
        deadline = time.monotonic() + 30
        while True:
            with self.st.lock:
                if lid not in self.st.leases:
                    ctx.abort(grpc.StatusCode.NOT_FOUND,
                              "etcdserver: requested lease not found")
                holders = self.st.store.range_prefix(name + "/")
                if not holders or all(h["key"] == my_key
                                      for h in holders):
                    self.st.store.apply_txn(
                        Txn((), (("put", my_key, lid, lid),), ()))
                    return pb.LockResponse(
                        header=pb.ResponseHeader(
                            revision=self.st.store.revision),
                        key=my_key.encode("utf-8"))
            if time.monotonic() > deadline:
                ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                          "lock wait deadline")
            time.sleep(0.01)

    def unlock(self, req: pb.UnlockRequest, ctx) -> pb.UnlockResponse:
        with self.st.lock:
            self.st.store.apply_txn(
                Txn((), (("delete", req.key.decode("utf-8")),), ()))
        return pb.UnlockResponse()

    # ---- cluster / maintenance --------------------------------------------

    def _member_pb(self, mid: int) -> pb.Member:
        m = self.st.members[mid]
        return pb.Member(ID=mid, name=m.get("name", ""),
                         peerURLs=list(m.get("peerURLs", ())),
                         clientURLs=(list(m.get("clientURLs", ()))
                                     or ["grpc://local"]))

    def member_list(self, req, ctx) -> pb.MemberListResponse:
        with self.st.lock:
            return pb.MemberListResponse(
                members=[self._member_pb(mid)
                         for mid in sorted(self.st.members)])

    def member_add(self, req: pb.MemberAddRequest,
                   ctx) -> pb.MemberAddResponse:
        import grpc
        peer_urls = list(req.peerURLs)
        if not peer_urls:
            ctx.abort(grpc.StatusCode.INVALID_ARGUMENT,
                      "etcdserver: peerURL exists or is empty")
        mid = member_id_for_peer_urls(peer_urls)
        with self.st.lock:
            if mid in self.st.members:
                ctx.abort(grpc.StatusCode.ALREADY_EXISTS,
                          "etcdserver: member ID already exist")
            self.st.members[mid] = {"name": "", "peerURLs": peer_urls,
                                    "clientURLs": []}
            return pb.MemberAddResponse(
                header=pb.ResponseHeader(
                    revision=self.st.store.revision,
                    member_id=self.st.member_id),
                member=pb.Member(ID=mid, peerURLs=peer_urls),
                members=[self._member_pb(m)
                         for m in sorted(self.st.members)])

    def member_remove(self, req, ctx) -> pb.MemberRemoveResponse:
        import grpc
        mid = int(req.ID)
        with self.st.lock:
            if mid not in self.st.members:
                ctx.abort(grpc.StatusCode.NOT_FOUND,
                          "etcdserver: member not found")
            if len(self.st.members) == 1:
                ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "etcdserver: re-configuration failed due to "
                          "not enough started members")
            del self.st.members[mid]
            return pb.MemberRemoveResponse(
                header=pb.ResponseHeader(
                    revision=self.st.store.revision,
                    member_id=self.st.member_id),
                members=[self._member_pb(m)
                         for m in sorted(self.st.members)])

    def status(self, req, ctx) -> pb.StatusResponse:
        with self.st.lock:
            rev = self.st.store.revision
            leader = self.st.leader_id()
            mid = self.st.member_id
        return pb.StatusResponse(
            header=pb.ResponseHeader(revision=rev, member_id=mid),
            leader=leader, raftTerm=2, raftIndex=rev,
            version="3.5.6-sim-gateway", dbSize=0)

    def defragment(self, req, ctx) -> pb.DefragmentResponse:
        return pb.DefragmentResponse()

    # ---- watch (bidi stream) ----------------------------------------------

    def watch(self, request_iterator: Iterator,
              ctx) -> Iterator[pb.WatchResponse]:
        first = next(request_iterator)
        create = first.create_request
        key = create.key.decode("utf-8")
        start = int(create.start_revision)
        yield pb.WatchResponse(created=True, watch_id=1)
        last = max(0, start - 1)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and ctx.is_active():
            with self.st.lock:
                try:
                    events = [e for e in
                              self.st.store.events_since(last + 1)
                              if e.key == key and e.revision > last]
                except SimError as e:
                    # compaction past the watch: cancel the stream with
                    # the compact horizon so the client restarts there
                    # (real etcd's watch cancel semantics). Anything
                    # else is a real bug and must propagate
                    if e.type != "compacted":
                        raise
                    yield pb.WatchResponse(
                        canceled=True, watch_id=1,
                        cancel_reason=(
                            "etcdserver: mvcc: required revision has "
                            "been compacted"),
                        compact_revision=int(
                            getattr(e, "compact_revision", None)
                            or self.st.store.compact_revision))
                    return
                rev = self.st.store.revision
            if events:
                last = max(e.revision for e in events)
                resp = pb.WatchResponse(
                    header=pb.ResponseHeader(revision=rev), watch_id=1)
                for e in events:
                    ev = resp.events.add()
                    ev.type = (pb.Event.DELETE if e.type == "delete"
                               else pb.Event.PUT)
                    if e.kv:
                        ev.kv.CopyFrom(_kv_wire(e.kv))
                    else:
                        ev.kv.key = e.key.encode("utf-8")
                        ev.kv.mod_revision = e.revision
                    if e.prev_kv:
                        ev.prev_kv.CopyFrom(_kv_wire(e.prev_kv))
                yield resp
            time.sleep(0.02)


def serve_grpc(port: int = 0, state: GatewayState = None):
    """Start the gRPC gateway on localhost:port (0 = ephemeral);
    returns (server, state, bound_port). Caller stop()s the server
    when done. Pass `state` to serve a pre-configured cluster
    surface."""
    import grpc
    from concurrent import futures

    state = state if state is not None else GatewayState()
    svc = _Services(state)

    def unary(fn, req_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString())

    def stream(fn, req_cls):
        return grpc.stream_stream_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString())

    handlers = [
        grpc.method_handlers_generic_handler("etcdserverpb.KV", {
            "Range": unary(svc.range, pb.RangeRequest),
            "Txn": unary(svc.txn, pb.TxnRequest),
            "Compact": unary(svc.compact, pb.CompactionRequest),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Lease", {
            "LeaseGrant": unary(svc.lease_grant, pb.LeaseGrantRequest),
            "LeaseRevoke": unary(svc.lease_revoke,
                                 pb.LeaseRevokeRequest),
            "LeaseKeepAlive": stream(svc.lease_keepalive,
                                     pb.LeaseKeepAliveRequest),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Watch", {
            "Watch": stream(svc.watch, pb.WatchRequest),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Cluster", {
            "MemberList": unary(svc.member_list, pb.MemberListRequest),
            "MemberAdd": unary(svc.member_add, pb.MemberAddRequest),
            "MemberRemove": unary(svc.member_remove,
                                  pb.MemberRemoveRequest),
        }),
        grpc.method_handlers_generic_handler(
            "etcdserverpb.Maintenance", {
                "Status": unary(svc.status, pb.StatusRequest),
                "Defragment": unary(svc.defragment,
                                    pb.DefragmentRequest),
            }),
        grpc.method_handlers_generic_handler("v3lockpb.Lock", {
            "Lock": unary(svc.lock, pb.LockRequest),
            "Unlock": unary(svc.unlock, pb.UnlockRequest),
        }),
    ]
    # watch and lock handlers PIN a worker for their whole stream /
    # spin duration (up to 300 s / 30 s), so the pool must comfortably
    # exceed the harness's worst-case concurrent watcher count — the
    # HTTP gateway's ThreadingHTTPServer is effectively unbounded
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=128),
        options=[("grpc.so_reuseport", 0)])
    for h in handlers:
        server.add_generic_rpc_handlers((h,))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, state, bound
