"""The client protocol: the full KV/txn/lease/lock/watch/cluster surface.

Re-designs the jetcd façade (``client.clj``) as an async Python protocol.
The one polymorphic seam — ``txn(cmps, then_ops, else_ops)`` — mirrors the
reference's single-method Client protocol (``client/support.clj:4-6``),
which is what lets the direct and etcdctl-style backends interchange.

All calls apply the 5 s client timeout (``client.clj:70-72``); timeouts
surface as indefinite errors.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..runner.sim import current_loop, wait_for, sleep, SECOND
from ..sut.cluster import Cluster
from ..sut.errors import SimError
from ..sut.store import Txn

TIMEOUT = 5 * SECOND  # reference: 5000ms


def compile_txn(cmps: list, then_ops: list, else_ops: list) -> Txn:
    """Compile the client AST into the server Txn shape (the analog of
    txn->java, client.clj:700-721)."""
    ccmps = []
    for c in cmps or []:
        op, key, (target, operand) = c
        ccmps.append((op, key, target.replace("-", "_"), operand))
    def comp_ops(ops):
        out = []
        for o in ops or []:
            if o[0] == "get":
                out.append(("get", o[1]))
            elif o[0] == "put":
                out.append(("put", o[1], o[2], o[3] if len(o) > 3 else 0))
            elif o[0] == "delete":
                out.append(("delete", o[1]))
            else:
                raise ValueError(f"unknown txn op {o!r}")
        return out
    return Txn(tuple(ccmps), tuple(comp_ops(then_ops)),
               tuple(comp_ops(else_ops)))


def txn_result(raw: dict) -> dict:
    """Convert a server txn result into the client shape (the analog of
    the ToClj conversions + result zipping, client.clj:723-750)."""
    gets = [r[1] for r in raw["results"] if r[0] == "get"]
    puts = [{"prev-kv": r[1]} for r in raw["results"] if r[0] == "put"]
    return {
        "succeeded": raw["succeeded"],
        "results": raw["results"],
        "gets": gets,
        "puts": puts,
        "header": {"revision": raw["revision"]},
    }


class Client:
    """Base client; subclasses implement _txn_rpc (the backend seam)."""

    def __init__(self, cluster: Cluster, node: str):
        self.cluster = cluster
        self.node = node
        self.open = True

    # ---- plumbing ---------------------------------------------------------

    async def _call(self, coro, timeout: int = TIMEOUT) -> Any:
        """Issue an RPC with the client timeout."""
        if not self.open:
            coro.close()  # silence "never awaited" — arg already built
            raise SimError("closed-client", self.node)
        loop = current_loop()
        if self.cluster.tracer is not None:
            method = getattr(coro, "__qualname__", "rpc").split(".")[-1]
            self.cluster.tracer.record("client-rpc", "client", self.node,
                                       method=method)
        task = loop.spawn(coro, name=f"rpc-{self.node}")
        return await wait_for(task, timeout)

    async def _txn_rpc(self, txn: Txn) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        self.open = False

    # ---- txn seam (support.clj Client protocol) ---------------------------

    async def txn(self, cmps: list, then_ops: list,
                  else_ops: list = None) -> dict:
        """If/Then/Else transaction (client.clj:464-485)."""
        t = compile_txn(cmps or [], then_ops or [], else_ops or [])
        raw = await self._txn_rpc(t)
        return txn_result(raw)

    # ---- KV sugar (client.clj:405-527) ------------------------------------

    async def get(self, k: str, serializable: bool = False) -> Optional[dict]:
        """Read one key; returns the kv map or None (client.clj:432-462)."""
        out = await self._call(self.cluster.kv_read(
            self.node, k, serializable=serializable))
        return out["kv"]

    async def put(self, k: str, v: Any) -> dict:
        """Write, returning prev-kv (client.clj:424-430)."""
        res = await self.txn([], [("put", k, v)])
        return res["puts"][0] | {"header": res["header"]}

    async def cas(self, k: str, old: Any, new: Any) -> dict:
        """Value compare-and-set (cas*!, client.clj:487-492)."""
        from . import txn as t
        return await self.txn([t.eq(k, t.value(old))], [t.put(k, new)])

    async def cas_revision(self, k: str, rev: int, new: Any) -> dict:
        """Mod-revision CAS (client.clj:502-509)."""
        from . import txn as t
        return await self.txn([t.eq(k, t.mod_revision(rev))], [t.put(k, new)])

    async def swap(self, k: str, f: Callable[[Any], Any]) -> Any:
        """CAS retry loop with random <=50ms backoff (client.clj:511-527).

        Returns the new value. Reads use linearizable gets; absent keys
        CAS on version 0.
        """
        from . import txn as t
        loop = current_loop()
        while True:
            cur = await self.get(k)
            if cur is None:
                new = f(None)
                res = await self.txn([t.eq(k, t.version(0))],
                                     [t.put(k, new)])
            else:
                new = f(cur["value"])
                res = await self.txn(
                    [t.eq(k, t.mod_revision(cur["mod-revision"]))],
                    [t.put(k, new)])
            if res["succeeded"]:
                return new
            await sleep(loop.rng.randint(0, 50_000_000))

    async def revision(self) -> int:
        """Current cluster revision (client.clj:695-698)."""
        out = await self._call(self.cluster.kv_read(self.node, "\x00"))
        return out["revision"]

    # ---- leases (client.clj:529-554) --------------------------------------

    async def lease_grant(self, ttl_ns: int) -> int:
        return await self._call(self.cluster.lease_grant(self.node, ttl_ns))

    async def lease_revoke(self, lease_id: int) -> None:
        await self._call(self.cluster.lease_revoke(self.node, lease_id))

    async def lease_keepalive_once(self, lease_id: int) -> int:
        return await self._call(
            self.cluster.lease_keepalive(self.node, lease_id))

    def spawn_keepalive(self, lease_id: int, interval_ns: int):
        """Background keepalive stream (client.clj:544-554 StreamObserver);
        returns the task — cancel it to stop."""
        loop = current_loop()

        async def pump():
            while True:
                await sleep(interval_ns)
                try:
                    await self.lease_keepalive_once(lease_id)
                except (SimError, TimeoutError):
                    return  # stream broken

        return loop.spawn(pump(), name=f"keepalive-{lease_id:x}")

    # ---- locks (client.clj:556-569) ---------------------------------------

    async def acquire_lock(self, name: str, lease_id: int,
                           timeout: int = TIMEOUT) -> str:
        return await self._call(
            self.cluster.lock(self.node, name, lease_id), timeout)

    async def release_lock(self, lock_key: str) -> None:
        await self._call(self.cluster.unlock(self.node, lock_key))

    # ---- watch (client.clj:663-693) ---------------------------------------

    def watch(self, k: str, from_revision: int,
              on_events: Callable, on_error: Callable):
        """Open a watch stream from a revision; returns a cancelable."""
        return self.cluster.watch(self.node, k, from_revision,
                                  on_events, on_error)

    # ---- membership (client.clj:571-636) ----------------------------------

    async def member_list(self) -> list[dict]:
        """Member maps {id, name, peer-urls, client-urls}
        (list-members, client.clj:571-579)."""
        return await self._call(self.cluster.member_list(self.node))

    async def member_id_of_node(self, node: str) -> int:
        """node name -> member id (member-id-of-node, client.clj:581-595);
        raises if the node is not a member."""
        for m in await self.member_list():
            if m["name"] == node:
                return m["id"]
        raise SimError("member-not-found", node)

    async def node_of_member_id(self, member_id: int) -> str:
        """member id -> node name (node-of-member-id, client.clj:597-613);
        raises if no member has that id."""
        for m in await self.member_list():
            if m["id"] == member_id:
                return m["name"]
        raise SimError("member-not-found", hex(member_id))

    async def add_member(self, name: str) -> None:
        await self._call(self.cluster.member_add(self.node, name))

    async def remove_member(self, name: str) -> None:
        await self._call(self.cluster.member_remove(self.node, name))

    async def remove_member_by_id(self, member_id: int) -> None:
        """Remove by id like the reference's remove-member!
        (client.clj:624-636 resolves the id first)."""
        await self.remove_member(await self.node_of_member_id(member_id))

    # ---- maintenance (client.clj:638-661) ---------------------------------

    async def status(self) -> dict:
        return await self._call(self.cluster.status(self.node))

    async def compact(self, rev: int, physical: bool = True) -> None:
        await self._call(self.cluster.compact(self.node, rev, physical))

    async def defrag(self) -> None:
        await self._call(self.cluster.defrag(self.node))

    async def await_node_ready(self, max_tries: int = 20) -> bool:
        """Retry status until the node reports a leader
        (client.clj:652-661)."""
        for _ in range(max_tries):
            try:
                st = await self.status()
                if st.get("leader") is not None or st.get("is-leader"):
                    return True
            except (SimError, TimeoutError):
                pass
            await sleep(1 * SECOND)
        raise SimError("unavailable",
                       f"node {self.node} never became ready")
