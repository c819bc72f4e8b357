"""DB protocol for a live (external) etcd cluster.

The reference's db.clj owns the whole node lifecycle over SSH —
install, start, kill, wipe. In live mode this harness drives an etcd it
did NOT start and has no shell on, so the DB layer shrinks to what the
wire offers: readiness barriers (client.clj:652-661) and member-status
primaries (db.clj:38-52). Process-level faults (kill/pause/wipe) need a
control plane this environment doesn't have; fault testing lives in the
simulated cluster, which models those faults at the byte level.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..runner.sim import current_loop, gather
from ..sut.errors import SimError

logger = logging.getLogger("jepsen_etcd_tpu_torch.db")


def _live_client_cls(opts: dict):
    """The live client class for this run's wire protocol (http = v3
    JSON gateway, grpc = native gRPC — the reference's protocol)."""
    if (opts or {}).get("client_type") == "grpc":
        from ..client.etcd_grpc import GrpcEtcdClient
        return GrpcEtcdClient
    from ..client.etcd_http import HttpEtcdClient
    return HttpEtcdClient


class LiveDb:
    """jepsen.db against an already-running cluster: setup is a
    readiness barrier, teardown leaves the cluster alone."""

    def __init__(self, opts: dict):
        self.opts = opts
        self.members: Optional[set] = None

    async def setup(self, test: dict) -> None:
        self.members = set(test["nodes"])
        loop = current_loop()
        cls = _live_client_cls(test)
        clients = [cls(ep) for ep in test["nodes"]]
        try:
            await gather(*[loop.spawn(c.await_node_ready())
                           for c in clients])
        finally:
            for c in clients:  # gRPC clients own channels/threads
                c.close()
        logger.info("live cluster ready: %s", test["nodes"])

    async def teardown(self, test: dict) -> None:
        pass  # not ours to stop

    def log_files(self, test: dict) -> dict:
        return {}  # no shell on the nodes; logs stay remote

    # ---- Process protocol: no control plane --------------------------------

    def _unsupported(self, what: str) -> str:
        raise SimError("unsupported",
                       f"live mode cannot {what}: no control plane on an "
                       f"external cluster (use --db local to spawn and "
                       f"fault local etcd processes, or the simulated "
                       f"cluster)", definite=True)

    def start(self, test: dict, node: str) -> str:
        return self._unsupported("start nodes")

    def kill(self, test: dict, node: str) -> str:
        return self._unsupported("kill nodes")

    def pause(self, test: dict, node: str) -> str:
        return self._unsupported("pause nodes")

    def resume(self, test: dict, node: str) -> str:
        return self._unsupported("resume nodes")

    def wipe(self, test: dict, node: str) -> str:
        return self._unsupported("wipe nodes")

    # ---- Primary protocol --------------------------------------------------

    async def primaries(self, test: dict) -> list[str]:
        """Highest-raft-term status answer wins (db.clj:38-52), mapped
        back to the endpoint whose member id is the reported leader."""
        loop = current_loop()
        cls = _live_client_cls(self.opts)

        async def ask(ep):
            c = cls(ep)
            try:
                return ep, await c.status()
            except (SimError, TimeoutError):
                return ep, None
            finally:
                c.close()

        answers = [a for a in await gather(
            *[loop.spawn(ask(ep)) for ep in sorted(self.members)])
            if a[1] is not None]
        if not answers:
            return []
        _, best = max(answers, key=lambda a: a[1].get("raft-term", 0))
        leader_id = best.get("leader")
        if not leader_id:
            return []
        # the endpoint whose own member id IS the leader id (its status
        # header carries its member_id); a term-leading follower that
        # merely *names* the leader is not the primary
        for ep, st in answers:
            member_id = int(st.get("header", {}).get("member_id", 0) or 0)
            if member_id == leader_id:
                return [ep]
        return []


def live_db(opts: dict) -> LiveDb:
    return LiveDb(opts)
