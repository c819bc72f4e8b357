"""Real-etcd client backend over the etcd v3 gRPC-JSON gateway.

SURVEY §7 step 11 (the optional real-etcd adapter): the client seam
makes this additive — the same ``Client`` surface (base.py) implemented
against a live etcd's HTTP gateway (``/v3/kv/txn`` etc., the JSON face
of the gRPC API jetcd speaks in the reference, client.clj:14-68)
instead of the simulated cluster. Runs on a ``WallLoop``
(runner/wall.py): every request is blocking I/O on its thread pool,
re-entering the loop via call_soon_threadsafe.

Values are JSON-encoded into etcd byte values (the role jepsen.codec
plays in the reference, client.clj:80-101); keys are UTF-8. Errors map
into the same taxonomy keywords as the simulated backend
(sut/errors.py), so ``with_errors`` classification — and therefore
history semantics — are identical across sim and real runs.

Hermetic tests drive this adapter against ``sut/http_gateway.py`` — the
same wire format served from the simulated MVCC store — so the adapter
is exercised end-to-end without a real etcd; pointed at a real
cluster's client URL it speaks the same protocol.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Callable, Optional

import urllib.error
import urllib.request

from ..runner.sim import current_loop, wait_for, SECOND
from ..sut.errors import SimError
from ..sut.store import Txn
from .errors import remap_etcd_message
from .base import Client, TIMEOUT, txn_result

_TARGETS = {"value": ("VALUE", "value"),
            "version": ("VERSION", "version"),
            "mod_revision": ("MOD", "mod_revision"),
            "create_revision": ("CREATE", "create_revision")}
_RESULTS = {"=": "EQUAL", "<": "LESS", ">": "GREATER"}

# gRPC status code -> taxonomy keyword (definiteness comes from
# sut/errors.ERROR_TYPES) — the code of the gRPC error jetcd would have
# seen (client.clj:279-379). Message remaps take precedence: etcd packs
# specific conditions (lease-not-found, raft-stopped, leader-changed)
# under generic codes (5/14).
_GRPC_CODES = {
    4: "timeout",            # DEADLINE_EXCEEDED
    5: "key-not-found",      # NOT_FOUND
    6: "duplicate-key",      # ALREADY_EXISTS
    8: "too-many-requests",
    11: "compacted",         # OUT_OF_RANGE: compacted revision
    14: "unavailable",       # UNAVAILABLE
    16: "invalid-auth-token",
}


def _b64(s: bytes) -> str:
    return base64.b64encode(s).decode("ascii")


def _key64(k: str) -> str:
    return _b64(k.encode("utf-8"))


def _val64(v: Any) -> str:
    return _b64(json.dumps(v).encode("utf-8"))


def _unkey(s: str) -> str:
    return base64.b64decode(s).decode("utf-8")


def _unval(s: Optional[str]) -> Any:
    if s is None:
        return None
    raw = base64.b64decode(s)
    try:
        return json.loads(raw)
    except ValueError:
        return raw.decode("utf-8", "replace")  # non-codec writer


def _kv_from_wire(kv: dict) -> dict:
    return {
        "key": _unkey(kv["key"]),
        "value": _unval(kv.get("value")),
        "version": int(kv.get("version", 0)),
        "create-revision": int(kv.get("create_revision", 0)),
        "mod-revision": int(kv.get("mod_revision", 0)),
        "lease": int(kv.get("lease", 0)),
    }


def _classify_http_error(e: BaseException) -> SimError:
    if isinstance(e, urllib.error.HTTPError):
        try:
            body = json.loads(e.read().decode("utf-8", "replace"))
        except Exception:
            body = {}
        code = int(body.get("code", -1))
        msg = body.get("message") or body.get("error") or str(e)
        # message remaps FIRST (client.clj:302-353), shared with the
        # native-gRPC adapter so the same server fault classifies
        # identically per --client-type
        remapped = remap_etcd_message(msg)
        if remapped is not None:
            return remapped
        if code in _GRPC_CODES:
            return SimError(_GRPC_CODES[code], msg)
        return SimError("unavailable", msg, definite=False)
    if isinstance(e, urllib.error.URLError):
        return SimError("connect-failed", str(e.reason))
    return SimError("unavailable", repr(e), definite=False)


class HttpEtcdClient(Client):
    """The real-etcd backend; same public surface as the sim-backed
    Client, minus the sim-only fault hooks."""

    def __init__(self, endpoint: str):
        # deliberately no super().__init__: there is no simulated cluster
        self.endpoint = endpoint.rstrip("/")
        self.node = self.endpoint
        self.cluster = None
        self.open = True

    # ---- plumbing ----------------------------------------------------------

    def _post_sync(self, path: str, body: dict,
                   timeout_s: float) -> dict:
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    async def _post(self, path: str, body: dict,
                    timeout: int = TIMEOUT) -> dict:
        if not self.open:
            raise SimError("closed-client", self.endpoint)
        loop = current_loop()
        if not hasattr(loop, "run_in_thread"):
            raise RuntimeError("HttpEtcdClient needs a WallLoop "
                               "(runner/wall.py): real I/O cannot run "
                               "on the virtual-time SimLoop")
        fut = loop.run_in_thread(self._post_sync, path, body,
                                 max(0.1, timeout / SECOND))
        try:
            return await wait_for(fut, timeout)
        except (SimError, TimeoutError):
            raise
        except BaseException as e:
            raise _classify_http_error(e) from e

    # ---- txn seam ----------------------------------------------------------

    async def _txn_rpc(self, txn: Txn) -> dict:
        body: dict = {"compare": [], "success": [], "failure": []}
        for op, key, target, operand in txn.cmps:
            tgt, field = _TARGETS[target]
            c = {"key": _key64(key), "target": tgt,
                 "result": _RESULTS[op]}
            c[field] = _val64(operand) if target == "value" \
                else int(operand)
            body["compare"].append(c)
        for branch, ops in (("success", txn.then_ops),
                            ("failure", txn.else_ops)):
            for o in ops:
                if o[0] == "get":
                    body[branch].append(
                        {"request_range": {"key": _key64(o[1])}})
                elif o[0] == "put":
                    body[branch].append({"request_put": {
                        "key": _key64(o[1]), "value": _val64(o[2]),
                        "lease": int(o[3]) if len(o) > 3 else 0,
                        "prev_kv": True}})
                else:
                    body[branch].append({"request_delete_range": {
                        "key": _key64(o[1]), "prev_kv": True}})
        raw = await self._post("/v3/kv/txn", body)
        results = []
        applied = txn.then_ops if raw.get("succeeded") else txn.else_ops
        for o, r in zip(applied, raw.get("responses", [])):
            if o[0] == "get":
                kvs = r.get("response_range", {}).get("kvs", [])
                results.append(
                    ("get", _kv_from_wire(kvs[0]) if kvs else None))
            elif o[0] == "put":
                prev = r.get("response_put", {}).get("prev_kv")
                results.append(
                    ("put", _kv_from_wire(prev) if prev else None))
            else:
                results.append(("delete", int(
                    r.get("response_delete_range", {}).get("deleted",
                                                           0))))
        return {"succeeded": bool(raw.get("succeeded")),
                "results": results,
                "revision": int(raw.get("header", {}).get("revision", 0))}

    # ---- KV ----------------------------------------------------------------

    async def get(self, k: str, serializable: bool = False
                  ) -> Optional[dict]:
        raw = await self._post("/v3/kv/range", {
            "key": _key64(k), "limit": 1, "serializable": serializable})
        kvs = raw.get("kvs", [])
        return _kv_from_wire(kvs[0]) if kvs else None

    async def revision(self) -> int:
        raw = await self._post("/v3/kv/range",
                               {"key": _key64("\x00"), "limit": 1})
        return int(raw.get("header", {}).get("revision", 0))

    # ---- leases ------------------------------------------------------------

    async def lease_grant(self, ttl_ns: int) -> int:
        # round UP: truncation would grant a 2.9s lease as TTL=2,
        # expiring earlier than the harness's lease math assumes
        ttl_s = max(1, -(-int(ttl_ns) // SECOND))
        raw = await self._post("/v3/lease/grant", {"TTL": ttl_s})
        return int(raw["ID"])

    async def lease_revoke(self, lease_id: int) -> None:
        await self._post("/v3/lease/revoke", {"ID": int(lease_id)})

    async def lease_keepalive_once(self, lease_id: int) -> int:
        raw = await self._post("/v3/lease/keepalive",
                               {"ID": int(lease_id)})
        res = raw.get("result", raw)
        ttl = int(res.get("TTL", 0))
        if ttl <= 0:
            raise SimError("lease-not-found", f"lease {lease_id:x}")
        return ttl * SECOND

    # ---- locks -------------------------------------------------------------

    async def acquire_lock(self, name: str, lease_id: int,
                           timeout: int = TIMEOUT) -> str:
        raw = await self._post("/v3/lock/lock",
                               {"name": _key64(name),
                                "lease": int(lease_id)}, timeout)
        return _unkey(raw["key"])

    async def release_lock(self, lock_key: str) -> None:
        await self._post("/v3/lock/unlock", {"key": _key64(lock_key)})

    # ---- watch -------------------------------------------------------------

    def watch(self, k: str, from_revision: int,
              on_events: Callable, on_error: Callable):
        """Streaming watch over the gateway (chunked JSON lines). Events
        arrive as sut.store.Event-shaped objects, matching the sim."""
        import threading

        from ..sut.store import Event
        loop = current_loop()
        stop = {"flag": False, "resp": None}

        def _shutdown_socket(resp) -> None:
            # resp.close() would deadlock on the buffered-reader lock a
            # blocked readline holds; shutting down the RAW socket
            # unblocks it immediately
            try:
                sock = resp.fp.raw._sock if resp is not None else None
                if sock is not None:
                    import socket as _socket
                    sock.shutdown(_socket.SHUT_RDWR)
            except Exception:
                pass  # already closed / implementation detail moved

        def reader():
            body = json.dumps({"create_request": {
                "key": _key64(k),
                "start_revision": int(from_revision)}}).encode("utf-8")
            req = urllib.request.Request(
                self.endpoint + "/v3/watch", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=3600) as resp:
                    stop["resp"] = resp
                    if stop["flag"]:
                        # cancel() ran while the connection was still
                        # being established (before resp existed): its
                        # socket shutdown missed, so do it ourselves or
                        # this daemon thread pins the connection until
                        # the 1h read timeout
                        _shutdown_socket(resp)
                        return
                    for line in resp:
                        if stop["flag"]:
                            return
                        msg = json.loads(line.decode("utf-8"))
                        res = msg.get("result", {})
                        if res.get("canceled"):
                            # servers also cancel watches for
                            # NON-compaction reasons (failed create,
                            # shutdown); classifying those as
                            # "compacted" would let the checker excuse
                            # real missing events as a phantom gap —
                            # gate on the compaction evidence
                            reason = res.get("cancel_reason", "canceled")
                            try:
                                cr = int(res.get("compact_revision"))
                            except (TypeError, ValueError):
                                # a non-numeric compact_revision (a
                                # gateway str() fallback can yield
                                # "None") must not escape as a generic
                                # error and lose the compaction framing
                                cr = 0
                            if cr > 0 or "compacted" in reason.lower():
                                # compaction cancel: carry the true
                                # horizon so the workload restarts
                                # there instead of at max-observed
                                # revision (which can overstate the
                                # unobservable gap)
                                err = SimError("compacted", reason)
                                if cr > 0:
                                    err.compact_revision = cr
                            else:
                                err = SimError("unavailable",
                                               f"watch canceled: "
                                               f"{reason}",
                                               definite=False)
                            if not stop["flag"]:
                                loop.call_soon_threadsafe(on_error, err)
                            return
                        evs = []
                        for e in res.get("events", []):
                            kv = _kv_from_wire(e["kv"]) if "kv" in e \
                                else None
                            prev = _kv_from_wire(e["prev_kv"]) \
                                if "prev_kv" in e else None
                            etype = ("delete" if e.get("type") == "DELETE"
                                     else "put")
                            rev = (kv or prev or {}).get(
                                "mod-revision",
                                int(res.get("header", {}).get(
                                    "revision", 0)))
                            evs.append(Event(type=etype,
                                             key=(kv or prev or
                                                  {"key": k})["key"],
                                             kv=kv, prev_kv=prev,
                                             revision=rev))
                        if evs and not stop["flag"]:
                            loop.call_soon_threadsafe(on_events, evs)
                    # stream EOF with neither a cancel frame nor a
                    # local cancel: the server went away mid-stream
                    # (killed node). Surface it as an indefinite outage
                    # so the consumer re-establishes the watch instead
                    # of waiting on a dead stream forever (same fix as
                    # the native-gRPC reader)
                    if not stop["flag"]:
                        loop.call_soon_threadsafe(on_error, SimError(
                            "unavailable",
                            "watch stream ended without cancel (server "
                            "went away)", definite=False))
            except BaseException as e:
                if not stop["flag"]:
                    loop.call_soon_threadsafe(
                        on_error, _classify_http_error(e))

        # a dedicated daemon thread, NOT the loop's pool: the stream
        # blocks in readline between events, which would pin a pool
        # worker and block interpreter exit on the atexit join
        threading.Thread(target=reader, daemon=True,
                         name=f"watch-{k}").start()

        class _Cancel:
            def cancel(self_inner):
                # order matters for the connect race: set the flag FIRST
                # so a reader that assigns stop['resp'] after this call
                # sees it and shuts its own socket down (see reader())
                stop["flag"] = True
                _shutdown_socket(stop.get("resp"))

        return _Cancel()

    # ---- membership / maintenance -----------------------------------------

    async def member_list(self) -> list[dict]:
        raw = await self._post("/v3/cluster/member/list", {})
        return [{"id": int(m["ID"]), "name": m.get("name", ""),
                 "peer-urls": m.get("peerURLs", []),
                 "client-urls": m.get("clientURLs", [])}
                for m in raw.get("members", [])]

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
        raw = await self._post("/v3/cluster/member/add",
                               {"peerURLs": list(peer_urls),
                                "isLearner": bool(is_learner)})
        m = raw.get("member", {})
        return {"id": int(m.get("ID", 0)), "name": m.get("name", ""),
                "peer-urls": list(m.get("peerURLs", ()))}

    async def remove_member(self, name: str) -> None:
        for m in await self.member_list():
            if m["name"] == name:
                await self.remove_member_by_id(m["id"])
                return
        raise SimError("member-not-found", name)

    async def remove_member_by_id(self, member_id: int) -> None:
        await self._post("/v3/cluster/member/remove",
                         {"ID": int(member_id)})

    async def status(self) -> dict:
        raw = await self._post("/v3/maintenance/status", {})
        return {"leader": int(raw.get("leader", 0)) or None,
                "version": raw.get("version"),
                "db-size": int(raw.get("dbSize", 0)),
                "raft-term": int(raw.get("raftTerm", 0)),
                "raft-index": int(raw.get("raftIndex", 0)),
                "header": raw.get("header", {})}

    async def compact(self, rev: int, physical: bool = True) -> None:
        await self._post("/v3/kv/compaction",
                         {"revision": int(rev), "physical": physical})

    async def defrag(self) -> None:
        await self._post("/v3/maintenance/defragment", {})

    # await_node_ready: the base Client implementation works unchanged
    # through the overridden status()
