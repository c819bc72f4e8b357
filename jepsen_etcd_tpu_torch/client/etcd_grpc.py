"""Real-etcd client backend over native gRPC — the reference's actual
wire protocol.

The reference's entire client traffic is gRPC/HTTP2 via jetcd
(project.clj:11, client.clj:14-68; commit path client.clj:723-750).
This adapter closes the one wire-protocol gap the JSON-gateway adapter
(etcd_http.py) left: it speaks etcdserverpb/v3lockpb directly over a
``grpc`` channel, using hand-maintained message classes
(client/proto/etcd_rpc.proto — field numbers mirror etcd's published
rpc.proto, see that file's header) and explicit method paths, so no
grpc_tools codegen is required.

Runs on a ``WallLoop`` like the HTTP adapter: every unary call is
blocking I/O on the loop's thread pool; the watch and lease-keepalive
streams live on dedicated daemon threads. Values are JSON-encoded into
etcd byte values (jepsen.codec's role, client.clj:80-101) — identical
bytes to the HTTP adapter and the etcdctl/direct sim clients, so
histories and checker semantics agree across every client type.

Error taxonomy: gRPC status codes map to the same keywords as
etcd_http._GRPC_CODES, message remaps first (client.clj:302-353 —
etcd hides specific conditions under generic codes). Hermetic tests
drive this adapter against ``sut/grpc_gateway.py`` (the same simulated
MVCC store served over real gRPC); pointed at a real cluster's client
URL it speaks the same protocol as jetcd.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Optional

from ..runner.sim import current_loop, wait_for, SECOND
from ..sut.errors import SimError
from ..sut.store import Txn
from .base import Client, TIMEOUT
from .errors import remap_etcd_message
from .proto import etcd_rpc_pb2 as pb

_TARGETS = {"value": pb.Compare.VALUE, "version": pb.Compare.VERSION,
            "mod_revision": pb.Compare.MOD,
            "create_revision": pb.Compare.CREATE}
_RESULTS = {"=": pb.Compare.EQUAL, "<": pb.Compare.LESS,
            ">": pb.Compare.GREATER}

#: gRPC StatusCode name -> taxonomy keyword (same table as the JSON
#: gateway adapter, keyed by symbolic name instead of numeric code)
_CODE_NAMES = {
    "DEADLINE_EXCEEDED": "timeout",
    "NOT_FOUND": "key-not-found",
    "ALREADY_EXISTS": "duplicate-key",
    "RESOURCE_EXHAUSTED": "too-many-requests",
    "OUT_OF_RANGE": "compacted",
    "UNAVAILABLE": "unavailable",
    "UNAUTHENTICATED": "invalid-auth-token",
}

#: method path -> (request class, response class); paths are the wire
#: contract (etcd's service/package names), independent of our local
#: proto package name
_METHODS = {
    "range": ("/etcdserverpb.KV/Range", pb.RangeRequest,
              pb.RangeResponse),
    "txn": ("/etcdserverpb.KV/Txn", pb.TxnRequest, pb.TxnResponse),
    "compact": ("/etcdserverpb.KV/Compact", pb.CompactionRequest,
                pb.CompactionResponse),
    "lease_grant": ("/etcdserverpb.Lease/LeaseGrant",
                    pb.LeaseGrantRequest, pb.LeaseGrantResponse),
    "lease_revoke": ("/etcdserverpb.Lease/LeaseRevoke",
                     pb.LeaseRevokeRequest, pb.LeaseRevokeResponse),
    "member_list": ("/etcdserverpb.Cluster/MemberList",
                    pb.MemberListRequest, pb.MemberListResponse),
    "member_add": ("/etcdserverpb.Cluster/MemberAdd",
                   pb.MemberAddRequest, pb.MemberAddResponse),
    "member_remove": ("/etcdserverpb.Cluster/MemberRemove",
                      pb.MemberRemoveRequest, pb.MemberRemoveResponse),
    "status": ("/etcdserverpb.Maintenance/Status", pb.StatusRequest,
               pb.StatusResponse),
    "defragment": ("/etcdserverpb.Maintenance/Defragment",
                   pb.DefragmentRequest, pb.DefragmentResponse),
    "lock": ("/v3lockpb.Lock/Lock", pb.LockRequest, pb.LockResponse),
    "unlock": ("/v3lockpb.Lock/Unlock", pb.UnlockRequest,
               pb.UnlockResponse),
}

WATCH_PATH = "/etcdserverpb.Watch/Watch"
KEEPALIVE_PATH = "/etcdserverpb.Lease/LeaseKeepAlive"


def _val_bytes(v: Any) -> bytes:
    return json.dumps(v).encode("utf-8")


def _unval(b: bytes) -> Any:
    if not b:
        return None
    try:
        return json.loads(b)
    except ValueError:
        return b.decode("utf-8", "replace")  # non-codec writer


def _kv_from_wire(kv: pb.KeyValue) -> dict:
    return {
        "key": kv.key.decode("utf-8"),
        "value": _unval(kv.value),
        "version": kv.version,
        "create-revision": kv.create_revision,
        "mod-revision": kv.mod_revision,
        "lease": kv.lease,
    }


def classify_grpc_error(e: BaseException) -> SimError:
    """RpcError -> taxonomy keyword. Message remaps FIRST
    (client.clj:302-353): etcd packs specific conditions
    (lease-not-found, raft-stopped, leader-changed) under generic
    codes."""
    import grpc

    if isinstance(e, grpc.RpcError):
        code = e.code() if callable(getattr(e, "code", None)) else None
        msg = (e.details() if callable(getattr(e, "details", None))
               else None) or str(e)
        remapped = remap_etcd_message(msg)
        if remapped is not None:
            return remapped
        name = code.name if code is not None else ""
        if name in _CODE_NAMES:
            return SimError(_CODE_NAMES[name], msg)
        if name == "CANCELLED":
            return SimError("closed-client", msg)
        return SimError("unavailable", msg, definite=False)
    return SimError("unavailable", repr(e), definite=False)


def _target(endpoint: str) -> str:
    """A client URL ('http://host:port') or bare 'host:port' -> the
    grpc channel target."""
    for scheme in ("http://", "https://"):
        if endpoint.startswith(scheme):
            return endpoint[len(scheme):].rstrip("/")
    return endpoint.rstrip("/")


class GrpcEtcdClient(Client):
    """The native-gRPC real-etcd backend; same public surface as the
    sim-backed Client, minus the sim-only fault hooks."""

    def __init__(self, endpoint: str):
        # deliberately no super().__init__: there is no simulated cluster
        import grpc

        self.endpoint = endpoint
        self.node = endpoint
        self.cluster = None
        self.open = True
        self._channel = grpc.insecure_channel(_target(endpoint))
        self._calls = {}
        for name, (path, req_cls, resp_cls) in _METHODS.items():
            self._calls[name] = self._channel.unary_unary(
                path, request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)
        self._watch_call = self._channel.stream_stream(
            WATCH_PATH,
            request_serializer=pb.WatchRequest.SerializeToString,
            response_deserializer=pb.WatchResponse.FromString)
        self._keepalive_call = self._channel.stream_stream(
            KEEPALIVE_PATH,
            request_serializer=pb.LeaseKeepAliveRequest.SerializeToString,
            response_deserializer=pb.LeaseKeepAliveResponse.FromString)

    # ---- plumbing ----------------------------------------------------------

    def _wall_loop(self):
        """The current loop, asserted to be a WallLoop — the one guard
        every real-I/O path (unary, keepalive stream, watch stream)
        shares, so a SimLoop gets this deliberate error instead of a
        bare AttributeError deep in a thread helper."""
        loop = current_loop()
        if not hasattr(loop, "run_in_thread"):
            raise RuntimeError("GrpcEtcdClient needs a WallLoop "
                               "(runner/wall.py): real I/O cannot run "
                               "on the virtual-time SimLoop")
        return loop

    async def _guarded(self, fn, *args, timeout: int = TIMEOUT):
        """Run blocking gRPC I/O on the WallLoop's thread pool with the
        client timeout and taxonomy classification."""
        if not self.open:
            raise SimError("closed-client", self.endpoint)
        loop = self._wall_loop()
        fut = loop.run_in_thread(fn, *args)
        try:
            return await wait_for(fut, timeout)
        except (SimError, TimeoutError):
            raise
        except BaseException as e:
            raise classify_grpc_error(e) from e

    async def _call(self, name: str, req, timeout: int = TIMEOUT):
        return await self._guarded(self._calls[name], req,
                                   max(0.1, timeout / SECOND),
                                   timeout=timeout)

    def close(self) -> None:
        self.open = False
        try:
            self._channel.close()
        except Exception:
            pass

    # ---- txn seam ----------------------------------------------------------

    async def _txn_rpc(self, txn: Txn) -> dict:
        req = pb.TxnRequest()
        for op, key, target, operand in txn.cmps:
            c = req.compare.add()
            c.key = key.encode("utf-8")
            c.target = _TARGETS[target]
            c.result = _RESULTS[op]
            if target == "value":
                c.value = _val_bytes(operand)
            elif target == "version":
                c.version = int(operand)
            elif target == "mod_revision":
                c.mod_revision = int(operand)
            else:
                c.create_revision = int(operand)
        for branch, ops in ((req.success, txn.then_ops),
                            (req.failure, txn.else_ops)):
            for o in ops:
                ro = branch.add()
                if o[0] == "get":
                    ro.request_range.key = o[1].encode("utf-8")
                elif o[0] == "put":
                    ro.request_put.key = o[1].encode("utf-8")
                    ro.request_put.value = _val_bytes(o[2])
                    if len(o) > 3:
                        ro.request_put.lease = int(o[3])
                    ro.request_put.prev_kv = True
                else:
                    ro.request_delete_range.key = o[1].encode("utf-8")
                    ro.request_delete_range.prev_kv = True
        raw = await self._call("txn", req)
        results = []
        applied = txn.then_ops if raw.succeeded else txn.else_ops
        for o, r in zip(applied, raw.responses):
            if o[0] == "get":
                kvs = r.response_range.kvs
                results.append(
                    ("get", _kv_from_wire(kvs[0]) if kvs else None))
            elif o[0] == "put":
                prev = (r.response_put.prev_kv
                        if r.response_put.HasField("prev_kv") else None)
                results.append(
                    ("put", _kv_from_wire(prev) if prev else None))
            else:
                results.append(
                    ("delete", int(r.response_delete_range.deleted)))
        return {"succeeded": bool(raw.succeeded), "results": results,
                "revision": int(raw.header.revision)}

    # ---- KV ----------------------------------------------------------------

    async def get(self, k: str, serializable: bool = False
                  ) -> Optional[dict]:
        raw = await self._call("range", pb.RangeRequest(
            key=k.encode("utf-8"), limit=1, serializable=serializable))
        return _kv_from_wire(raw.kvs[0]) if raw.kvs else None

    async def revision(self) -> int:
        raw = await self._call("range",
                               pb.RangeRequest(key=b"\x00", limit=1))
        return int(raw.header.revision)

    # ---- leases ------------------------------------------------------------

    async def lease_grant(self, ttl_ns: int) -> int:
        # round UP: truncation would grant a 2.9s lease as TTL=2,
        # expiring earlier than the harness's lease math assumes
        ttl_s = max(1, -(-int(ttl_ns) // SECOND))
        raw = await self._call("lease_grant",
                               pb.LeaseGrantRequest(TTL=ttl_s))
        return int(raw.ID)

    async def lease_revoke(self, lease_id: int) -> None:
        await self._call("lease_revoke",
                         pb.LeaseRevokeRequest(ID=int(lease_id)))

    def _keepalive_sync(self, lease_id: int, timeout_s: float) -> int:
        """One round on the LeaseKeepAlive bidi stream (jetcd keeps a
        long-lived stream; one-shot preserves the same wire frames)."""
        call = self._keepalive_call(
            iter([pb.LeaseKeepAliveRequest(ID=int(lease_id))]),
            timeout=timeout_s)
        try:
            resp = next(iter(call))
        finally:
            call.cancel()
        return int(resp.TTL)

    async def lease_keepalive_once(self, lease_id: int) -> int:
        ttl = await self._guarded(self._keepalive_sync, lease_id,
                                  max(0.1, TIMEOUT / SECOND))
        if ttl <= 0:
            raise SimError("lease-not-found", f"lease {lease_id:x}")
        return ttl * SECOND

    # ---- locks -------------------------------------------------------------

    async def acquire_lock(self, name: str, lease_id: int,
                           timeout: int = TIMEOUT) -> str:
        raw = await self._call("lock", pb.LockRequest(
            name=name.encode("utf-8"), lease=int(lease_id)), timeout)
        return raw.key.decode("utf-8")

    async def release_lock(self, lock_key: str) -> None:
        await self._call("unlock", pb.UnlockRequest(
            key=lock_key.encode("utf-8")))

    # ---- watch -------------------------------------------------------------

    def watch(self, k: str, from_revision: int,
              on_events: Callable, on_error: Callable):
        """Streaming watch on the etcdserverpb.Watch bidi stream.
        Events arrive as sut.store.Event-shaped objects, matching the
        sim and the JSON-gateway adapter."""
        from ..sut.store import Event

        loop = self._wall_loop()
        stop = {"flag": False, "call": None}
        started = threading.Event()

        def requests():
            req = pb.WatchRequest()
            req.create_request.key = k.encode("utf-8")
            req.create_request.start_revision = int(from_revision)
            req.create_request.prev_kv = True
            yield req
            started.wait()  # hold the send side open until cancel

        def reader():
            call = None
            try:
                call = self._watch_call(requests(), timeout=3600)
                stop["call"] = call
                if stop["flag"]:
                    return
                for msg in call:
                    if stop["flag"]:
                        return
                    if msg.canceled:
                        # servers also cancel watches for NON-compaction
                        # reasons (failed create, shutdown); gate the
                        # "compacted" classification on the compaction
                        # evidence so real missing events can't hide
                        # behind a phantom gap
                        reason = msg.cancel_reason or "canceled"
                        cr = int(msg.compact_revision)
                        if cr > 0 or "compacted" in reason.lower():
                            err = SimError("compacted", reason)
                            if cr > 0:
                                err.compact_revision = cr
                        else:
                            err = SimError(
                                "unavailable",
                                f"watch canceled: {reason}",
                                definite=False)
                        if not stop["flag"]:
                            loop.call_soon_threadsafe(on_error, err)
                        return
                    evs = []
                    for e in msg.events:
                        kv = (_kv_from_wire(e.kv)
                              if e.HasField("kv") else None)
                        prev = (_kv_from_wire(e.prev_kv)
                                if e.HasField("prev_kv") else None)
                        etype = ("delete" if e.type == pb.Event.DELETE
                                 else "put")
                        rev = (kv or prev or {}).get(
                            "mod-revision", int(msg.header.revision))
                        evs.append(Event(
                            type=etype,
                            key=(kv or prev or {"key": k})["key"],
                            kv=kv, prev_kv=prev, revision=rev))
                    if evs and not stop["flag"]:
                        loop.call_soon_threadsafe(on_events, evs)
                # the stream ended with neither a cancel frame nor a
                # local cancel: the server side went away mid-stream
                # (killed node, closed connection). A silent return here
                # would strand the consumer on a dead watch forever —
                # surface it as an indefinite outage so it re-establishes
                if not stop["flag"]:
                    loop.call_soon_threadsafe(on_error, SimError(
                        "unavailable",
                        "watch stream ended without cancel (server "
                        "went away)", definite=False))
            except BaseException as e:
                if not stop["flag"]:
                    loop.call_soon_threadsafe(
                        on_error, classify_grpc_error(e))
            finally:
                # EVERY exit releases the request generator and the
                # call: a server-initiated end (compaction cancel,
                # error, stream close) must not leave grpc's request-
                # consumer thread parked in started.wait() forever
                started.set()
                if call is not None:
                    try:
                        call.cancel()
                    except Exception:
                        pass

        threading.Thread(target=reader, daemon=True,
                         name=f"watch-{k}").start()

        class _Cancel:
            def cancel(self_inner):
                # flag FIRST: a reader assigning stop['call'] after this
                # call sees it and cancels its own stream (connect race)
                stop["flag"] = True
                started.set()  # release the request generator
                call = stop.get("call")
                if call is not None:
                    try:
                        call.cancel()
                    except Exception:
                        pass

        return _Cancel()

    # ---- membership / maintenance -----------------------------------------

    async def member_list(self) -> list[dict]:
        raw = await self._call("member_list", pb.MemberListRequest())
        return [{"id": int(m.ID), "name": m.name,
                 "peer-urls": list(m.peerURLs),
                 "client-urls": list(m.clientURLs)}
                for m in raw.members]

    async def add_member(self, name: str) -> None:
        raise SimError("unavailable",
                       "member add needs peer URLs: use "
                       "member_add_urls (the local control plane, "
                       "db/local.py, supplies them)", definite=True)

    async def member_add_urls(self, peer_urls: list[str],
                              is_learner: bool = False) -> dict:
        """Real member add (MemberAdd, client.clj:615-622 analog): the
        caller — the local control plane — knows the new node's peer
        URLs before it starts. Returns the new member map."""
        raw = await self._call("member_add", pb.MemberAddRequest(
            peerURLs=list(peer_urls), isLearner=bool(is_learner)))
        return {"id": int(raw.member.ID), "name": raw.member.name,
                "peer-urls": list(raw.member.peerURLs)}

    async def remove_member(self, name: str) -> None:
        for m in await self.member_list():
            if m["name"] == name:
                await self.remove_member_by_id(m["id"])
                return
        raise SimError("member-not-found", name)

    async def remove_member_by_id(self, member_id: int) -> None:
        await self._call("member_remove",
                         pb.MemberRemoveRequest(ID=int(member_id)))

    async def status(self) -> dict:
        raw = await self._call("status", pb.StatusRequest())
        return {"leader": int(raw.leader) or None,
                "version": raw.version,
                "db-size": int(raw.dbSize),
                "raft-term": int(raw.raftTerm),
                "raft-index": int(raw.raftIndex),
                "header": {"revision": int(raw.header.revision),
                           "member_id": int(raw.header.member_id)}}

    async def compact(self, rev: int, physical: bool = True) -> None:
        await self._call("compact", pb.CompactionRequest(
            revision=int(rev), physical=physical))

    async def defrag(self) -> None:
        await self._call("defragment", pb.DefragmentRequest())

    # await_node_ready: the base Client implementation works unchanged
    # through the overridden status()
