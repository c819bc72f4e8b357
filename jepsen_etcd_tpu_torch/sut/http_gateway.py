"""etcd v3 gRPC-JSON gateway server over the simulated MVCC store.

Two jobs:
- the hermetic test double for the real-etcd client adapter
  (client/etcd_http.py): the adapter speaks the same bytes to this
  server as to a live etcd, so its wire encoding (base64 keys/values,
  compare targets, txn branches, chunked watch streams) is exercised
  end-to-end without an etcd binary;
- a live etcd-wire KV endpoint backed by the simulated MVCC store
  (`python -m jepsen_etcd_tpu_torch gateway`) — real etcd tooling can talk
  to the simulated store interactively.

Single-node semantics only (one Store, total order via a lock): the
fault surface of the real adapter is the real cluster's, not this
gateway's.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from .errors import SimError
from .store import Store, Txn


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def _unkey(s: str) -> str:
    return base64.b64decode(s).decode("utf-8")


def _unval(s: str) -> Any:
    raw = base64.b64decode(s)
    try:
        return json.loads(raw)
    except ValueError:
        return raw.decode("utf-8", "replace")


def member_id_for_peer_urls(peer_urls) -> int:
    """Stable member id from peer URLs (stand-in for etcd's
    hash-of-peer-URLs+cluster-name id derivation): the same member gets
    the same id whether it is computed by a gateway handling MemberAdd
    or by the fake binary parsing --initial-cluster."""
    blob = ",".join(sorted(peer_urls)).encode("utf-8")
    return zlib.crc32(blob) or 1  # 0 is "no leader" on the wire


_TARGET_FIELD = {"VALUE": ("value", "value"),
                 "VERSION": ("version", "version"),
                 "MOD": ("mod_revision", "mod_revision"),
                 "CREATE": ("create_revision", "create_revision")}
_RESULT_OP = {"EQUAL": "=", "LESS": "<", "GREATER": ">"}


class GatewayState:
    def __init__(self, name: str = "gw0", member_id: int = 1,
                 members: Optional[dict[int, dict]] = None):
        self.store = Store()
        self.lock = threading.Lock()
        self.leases: dict[int, int] = {}  # id -> ttl seconds
        self.next_lease = 0x1000
        # cluster surface: which member this gateway claims to be, and
        # its view of the membership ({id: {"name", "peerURLs",
        # "clientURLs"}}). Defaults preserve the original single-member
        # gateway; the fake-etcd harness passes the full roster so the
        # member list / add / remove API behaves like a real node's.
        self.name = name
        self.member_id = member_id
        self.members: dict[int, dict] = members if members is not None else {
            member_id: {"name": name,
                        "peerURLs": ["http://localhost:0"],
                        "clientURLs": []}}
        # quorum surface: fake-etcd installs a callable reporting
        # whether this node currently sees a roster majority (peer
        # probes, db/fake_etcd.py). None = single-node / always-quorate.
        self.quorum_check = None

    def leader_id(self) -> int:
        # deterministic single leader across every node's view: the
        # lowest member id (fake nodes share no raft; min() agrees).
        # A node cut off from the roster majority has no leader — the
        # wire shape real etcd gives a partitioned minority.
        if self.quorum_check is not None and not self.quorum_check():
            return 0
        return min(self.members) if self.members else 0

    def member_wire(self, mid: int) -> dict:
        m = self.members[mid]
        return {"ID": str(mid), "name": m.get("name", ""),
                "peerURLs": list(m.get("peerURLs", ())),
                "clientURLs": list(m.get("clientURLs", ()))}

    def kv_wire(self, kv: dict) -> dict:
        return {
            "key": _b64(kv["key"].encode("utf-8")),
            "value": _b64(json.dumps(kv["value"]).encode("utf-8")),
            "version": str(kv["version"]),
            "create_revision": str(kv["create-revision"]),
            "mod_revision": str(kv["mod-revision"]),
            "lease": str(kv.get("lease", 0)),
        }


#: paths that need a quorum (writes, linearizable machinery): a real
#: etcd in a partitioned minority fails these with "no leader".
#: Serializable ranges, status, watches, member/list, and lease
#: keepalive stay served from local state, like real etcd.
QUORUM_PATHS = frozenset({
    "/v3/kv/txn", "/v3/kv/compaction",
    "/v3/lease/grant", "/v3/lease/revoke",
    "/v3/lock/lock", "/v3/lock/unlock",
    "/v3/cluster/member/add", "/v3/cluster/member/remove",
})


class _Handler(BaseHTTPRequestHandler):
    state: GatewayState = None  # set by serve()

    def log_message(self, *a):  # quiet
        pass

    def _json(self, obj: dict, code: int = 200) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, grpc_code: int, msg: str) -> None:
        self._json({"error": msg, "code": grpc_code, "message": msg},
                   code=code)

    def do_POST(self):  # noqa: N802 (stdlib naming)
        n = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except ValueError:
            return self._error(400, 3, "invalid json")
        st = self.state
        path = self.path
        # body may be any JSON value here (fuzzed frames send lists /
        # null); non-dict bodies fail per-path validation below
        needs_quorum = path in QUORUM_PATHS or (
            path == "/v3/kv/range" and not (
                isinstance(body, dict) and body.get("serializable")))
        if needs_quorum and st.quorum_check is not None \
                and not st.quorum_check():
            # same grpc code (14, unavailable) + message real etcd
            # emits, so client/etcd_http.py classifies identically
            return self._error(503, 14, "etcdserver: no leader")
        try:
            if path == "/v3/kv/range":
                # full Range semantics: optional range_end (half-open
                # interval; "\0" = from key onward) and limit, so real
                # etcd tooling (etcdctl get --prefix) gets correct
                # results. serializable is accepted and identical here:
                # a single-node gateway has no stale followers.
                key = _unkey(body["key"])
                range_end = _unkey(body["range_end"]) \
                    if body.get("range_end") else None
                limit = int(body.get("limit", 0))
                with st.lock:
                    kvs = st.store.range_interval(key, range_end)
                    rev = st.store.revision
                more = bool(limit) and len(kvs) > limit
                count = len(kvs)
                if limit:
                    kvs = kvs[:limit]
                return self._json({
                    "header": {"revision": str(rev)},
                    "kvs": [st.kv_wire(kv) for kv in kvs],
                    "more": more,
                    "count": str(count)})
            if path == "/v3/kv/txn":
                return self._txn(body)
            if path == "/v3/kv/compaction":
                with st.lock:
                    rev = int(body.get("revision", 0))
                    if rev <= st.store.compact_revision:
                        return self._error(
                            400, 11,
                            "etcdserver: mvcc: required revision has "
                            "been compacted")
                    st.store.compact(rev)
                    return self._json(
                        {"header": {"revision": str(st.store.revision)}})
            if path == "/v3/lease/grant":
                with st.lock:
                    st.next_lease += 1
                    lid = st.next_lease
                    st.leases[lid] = int(body.get("TTL", 1))
                return self._json({"ID": str(lid),
                                   "TTL": str(st.leases[lid])})
            if path == "/v3/lease/revoke":
                return self._lease_revoke(int(body["ID"]))
            if path == "/v3/lease/keepalive":
                lid = int(body["ID"])
                with st.lock:
                    ttl = st.leases.get(lid, 0)
                return self._json({"result": {"ID": str(lid),
                                              "TTL": str(ttl)}})
            if path == "/v3/lock/lock":
                return self._lock(body)
            if path == "/v3/lock/unlock":
                return self._unlock(body)
            if path == "/v3/cluster/member/list":
                with st.lock:
                    members = [st.member_wire(mid)
                               for mid in sorted(st.members)]
                # a default single-member gateway advertises its own
                # address (original behaviour); rosters injected by the
                # harness carry real client URLs already
                for m in members:
                    if not m["clientURLs"]:
                        m["clientURLs"] = [
                            f"http://{self.headers.get('Host')}"]
                return self._json({"members": members})
            if path == "/v3/cluster/member/add":
                return self._member_add(body)
            if path == "/v3/cluster/member/remove":
                return self._member_remove(body)
            if path == "/v3/maintenance/status":
                with st.lock:
                    rev = st.store.revision
                    leader = st.leader_id()
                    mid = st.member_id
                return self._json({
                    "header": {"revision": str(rev),
                               "member_id": str(mid)},
                    "leader": str(leader), "raftTerm": "2",
                    "raftIndex": str(rev),
                    "version": "3.5.6-sim-gateway", "dbSize": "0"})
            if path == "/v3/maintenance/defragment":
                return self._json({"header": {}})
            if path == "/v3/watch":
                return self._watch(body)
            return self._error(404, 12, f"unknown path {path}")
        except KeyError as e:
            return self._error(400, 3, f"missing field {e}")
        except (ValueError, TypeError) as e:
            return self._error(400, 3, f"malformed request: {e}")
        except Exception as e:  # store-side errors (e.g. compaction)
            msg = str(e)
            code = 11 if "compact" in msg.lower() else 13
            return self._error(400, code, msg)

    # -- kv txn --------------------------------------------------------------

    def _txn(self, body: dict) -> None:
        st = self.state
        cmps = []
        for c in body.get("compare", []):
            tgt = c.get("target", "VALUE")
            field, store_target = _TARGET_FIELD[tgt]
            operand = c.get(field)
            if tgt == "VALUE":
                operand = _unval(operand) if operand is not None else None
            else:
                operand = int(operand or 0)
            cmps.append((_RESULT_OP[c.get("result", "EQUAL")],
                         _unkey(c["key"]), store_target, operand))

        def branch(ops):
            out = []
            for o in ops:
                if "request_range" in o:
                    out.append(("get", _unkey(o["request_range"]["key"])))
                elif "request_put" in o:
                    p = o["request_put"]
                    out.append(("put", _unkey(p["key"]),
                                _unval(p["value"]),
                                int(p.get("lease", 0))))
                elif "request_delete_range" in o:
                    out.append(("delete",
                                _unkey(o["request_delete_range"]["key"])))
            return out

        txn = Txn(tuple(cmps), tuple(branch(body.get("success", []))),
                  tuple(branch(body.get("failure", []))))
        with st.lock:
            raw = st.store.apply_txn(txn)
        responses = []
        for r in raw["results"]:
            if r[0] == "get":
                responses.append({"response_range": {
                    "kvs": [st.kv_wire(r[1])] if r[1] else [],
                    "count": "1" if r[1] else "0"}})
            elif r[0] == "put":
                responses.append({"response_put": (
                    {"prev_kv": st.kv_wire(r[1])} if r[1] else {})})
            else:
                responses.append({"response_delete_range":
                                  {"deleted": str(r[1])}})
        self._json({"header": {"revision": str(raw["revision"])},
                    "succeeded": raw["succeeded"],
                    "responses": responses})

    # -- leases / locks ------------------------------------------------------

    def _lease_revoke(self, lid: int) -> None:
        st = self.state
        with st.lock:
            if lid not in st.leases:
                return self._error(
                    400, 5, "etcdserver: requested lease not found")
            del st.leases[lid]
            for key in sorted(st.store.lease_keys.get(lid, ())):
                st.store.apply_txn(Txn((), (("delete", key),), ()))
        self._json({"header": {}})

    def _lock(self, body: dict) -> None:
        st = self.state
        name = _unkey(body["name"])
        lid = int(body.get("lease", 0))
        my_key = f"{name}/{lid:016x}"
        deadline = time.monotonic() + 30
        while True:
            with st.lock:
                if lid not in st.leases:
                    return self._error(
                        400, 5, "etcdserver: requested lease not found")
                holders = st.store.range_prefix(name + "/")
                if not holders or all(h["key"] == my_key
                                      for h in holders):
                    st.store.apply_txn(
                        Txn((), (("put", my_key, lid, lid),), ()))
                    return self._json({
                        "key": _b64(my_key.encode("utf-8")),
                        "header": {"revision": str(st.store.revision)}})
            if time.monotonic() > deadline:
                return self._error(400, 4, "lock wait deadline")
            time.sleep(0.01)

    def _unlock(self, body: dict) -> None:
        st = self.state
        key = _unkey(body["key"])
        with st.lock:
            st.store.apply_txn(Txn((), (("delete", key),), ()))
        self._json({"header": {}})

    # -- cluster membership ---------------------------------------------------

    def _member_add(self, body: dict) -> None:
        st = self.state
        peer_urls = list(body.get("peerURLs") or ())
        if not peer_urls:
            return self._error(400, 3,
                               "etcdserver: peerURL exists or is empty")
        # same derivation as the fake binary (crc32 of sorted peer
        # URLs), so an added member keeps its id once it starts and
        # reports itself via --initial-cluster
        mid = member_id_for_peer_urls(peer_urls)
        with st.lock:
            if mid in st.members:
                return self._error(
                    400, 6, "etcdserver: member ID already exist")
            # like real etcd: an added-but-unstarted member has no name
            st.members[mid] = {"name": "", "peerURLs": peer_urls,
                               "clientURLs": []}
            members = [st.member_wire(m) for m in sorted(st.members)]
            rev = st.store.revision
        return self._json({
            "header": {"revision": str(rev),
                       "member_id": str(st.member_id)},
            "member": {"ID": str(mid), "name": "",
                       "peerURLs": peer_urls, "clientURLs": []},
            "members": members})

    def _member_remove(self, body: dict) -> None:
        st = self.state
        mid = int(body["ID"])
        with st.lock:
            if mid not in st.members:
                return self._error(
                    400, 5, "etcdserver: member not found")
            if len(st.members) == 1:
                return self._error(
                    400, 9,
                    "etcdserver: re-configuration failed due to not "
                    "enough started members")
            del st.members[mid]
            members = [st.member_wire(m) for m in sorted(st.members)]
            rev = st.store.revision
        return self._json({
            "header": {"revision": str(rev),
                       "member_id": str(st.member_id)},
            "members": members})

    # -- watch (chunked stream) ----------------------------------------------

    def _watch(self, body: dict) -> None:
        st = self.state
        start = int(body.get("create_request", {})
                    .get("start_revision", 0))
        key = _unkey(body["create_request"]["key"])
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj: dict) -> None:
            data = (json.dumps(obj) + "\n").encode("utf-8")
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data + b"\r\n")
            self.wfile.flush()

        chunk({"result": {"created": True, "header": {}}})
        last = max(0, start - 1)
        deadline = time.monotonic() + 300
        try:
            while time.monotonic() < deadline:
                with st.lock:
                    try:
                        events = [e for e in
                                  st.store.events_since(last + 1)
                                  if e.key == key and e.revision > last]
                    except SimError as e:
                        # compacted past the watch: real etcd cancels
                        # the stream with a WatchResponse carrying
                        # compact_revision so the client can restart
                        # past the horizon (api_reference: watch
                        # cancel semantics); mirror that framing.
                        # Only the store's compaction error — anything
                        # else is a real bug and must propagate, not
                        # masquerade as a compact cancel
                        if e.type != "compacted":
                            raise
                        chunk({"result": {
                            "canceled": True,
                            "cancel_reason":
                                "etcdserver: mvcc: required revision "
                                "has been compacted",
                            "compact_revision": str(
                                getattr(e, "compact_revision", None)
                                or st.store.compact_revision)}})
                        return
                    rev = st.store.revision
                if events:
                    last = max(e.revision for e in events)
                    chunk({"result": {
                        "header": {"revision": str(rev)},
                        "events": [{
                            "type": ("DELETE" if e.type == "delete"
                                     else "PUT"),
                            **({"kv": st.kv_wire(e.kv)} if e.kv else
                               {"kv": {
                                   "key": _b64(e.key.encode()),
                                   "mod_revision": str(e.revision)}}),
                            **({"prev_kv": st.kv_wire(e.prev_kv)}
                               if e.prev_kv else {}),
                        } for e in events]}})
                time.sleep(0.02)
        except (BrokenPipeError, ConnectionResetError):
            pass


def serve(port: int = 0,
          state: Optional[GatewayState] = None,
          ) -> tuple[ThreadingHTTPServer, GatewayState]:
    """Start the gateway on localhost:port (0 = ephemeral); returns
    (server, state). Caller runs server.serve_forever() in a thread and
    shutdown()s it when done. Pass `state` to serve a pre-configured
    cluster surface (the fake-etcd harness injects its roster)."""
    state = state if state is not None else GatewayState()
    handler = type("Handler", (_Handler,), {"state": state})
    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    # watch handlers poll between events; never block server_close (or
    # interpreter exit) on them
    srv.daemon_threads = True
    srv.block_on_close = False
    return srv, state
