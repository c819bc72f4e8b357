"""Cluster lifecycle automation (the db.clj analog).

Where the reference SSHes into nodes to install/start/kill/wipe real etcd
binaries, we drive the simulated cluster's fault API. The protocol surface
mirrors jepsen.db (DB/Process/Pause/Primary/LogFiles) as used by the
nemesis packages and test composition:

- setup/teardown with the initialized? barrier (db.clj:192-232): the first
  start bootstraps a fresh cluster ("--initial-cluster-state new"); later
  starts rejoin with existing data ("existing", db.clj:257-262);
- kill!/start! (with lazyfs lose-unfsynced-writes! on kill,
  db.clj:264-267), pause!/resume! (grepkill :stop/:cont, db.clj:269-271);
- grow!/shrink! membership changes (db.clj:128-190);
- primaries via the highest-raft-term fan-out (db.clj:38-52).
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from ..runner.sim import current_loop, sleep, gather, SECOND
from ..sut.cluster import Cluster
from ..sut.errors import SimError
from ..client import DirectClient

logger = logging.getLogger("jepsen_etcd_tpu_torch.db")


class Db:
    def __init__(self, opts: dict):
        self.opts = opts
        self.initialized = False          # db.clj:219-220 atom
        self.members: Optional[set] = None  # db.clj:107-112 atom
        self.next_node_id = 0
        self._corrupt_monitor = None

    # ---- DB protocol -------------------------------------------------------

    async def setup(self, test: dict) -> None:
        cluster: Cluster = test["cluster"]
        self.members = set(test["nodes"])
        self.next_node_id = len(test["nodes"])
        cluster.launch()
        # await-node-ready on every node (db.clj:212-215), in parallel
        loop = current_loop()
        clients = [DirectClient(cluster, n) for n in test["nodes"]]
        await gather(*[loop.spawn(c.await_node_ready())
                       for c in clients])
        self.initialized = True  # jepsen/synchronize barrier passed
        if test.get("lazyfs"):
            # pin the post-setup state (lazyfs checkpoint!, db.clj:222-223)
            for n in test["nodes"]:
                cluster.checkpoint_node(n)
        if test.get("corrupt_check"):
            # --corrupt-check (db.clj:97-99): initial check at boot, then
            # a periodic monitor every virtual minute, the
            # --experimental-corrupt-check-time 1m analog
            cluster.check_corruption()

            async def monitor():
                while cluster.running:
                    await sleep(60 * SECOND)
                    cluster.check_corruption()
            self._corrupt_monitor = loop.spawn(monitor(),
                                               "db-corrupt-monitor")

    async def teardown(self, test: dict) -> None:
        if test.get("corrupt_check"):
            # final sweep before shutdown freezes node state
            test["cluster"].check_corruption()
        test["cluster"].shutdown()

    def log_files(self, test: dict) -> dict:
        """node -> etcd.log lines (db.clj:234-242 collects logs + data)."""
        return {name: list(node.etcd_log)
                for name, node in test["cluster"].nodes.items()}

    # ---- Process protocol --------------------------------------------------

    def start(self, test: dict, node: str) -> str:
        cluster: Cluster = test["cluster"]
        try:
            cluster.start_node(node, fresh=not self.initialized)
            if test.get("corrupt_check"):
                # --experimental-initial-corrupt-check: verify at boot
                cluster.check_corruption()
            return "started"
        except SimError as e:
            if e.type == "corrupt":
                return "corrupt"  # node refuses to start; logged a panic
            raise

    def kill(self, test: dict, node: str) -> str:
        cluster: Cluster = test["cluster"]
        lose = bool(test.get("lazyfs"))
        cluster.kill_node(node, lose_unfsynced=lose)
        return "killed"

    def pause(self, test: dict, node: str) -> str:
        test["cluster"].pause_node(node)
        return "paused"

    def resume(self, test: dict, node: str) -> str:
        test["cluster"].resume_node(node)
        return "resumed"

    def wipe(self, test: dict, node: str) -> str:
        test["cluster"].wipe_node(node)
        return "wiped"

    # ---- Primary protocol --------------------------------------------------

    async def primaries(self, test: dict) -> list[str]:
        """Highest-raft-term answer wins (from-highest-term, db.clj:38-52)."""
        cluster: Cluster = test["cluster"]
        loop = current_loop()

        async def ask(n):
            try:
                c = DirectClient(cluster, n)
                return await c.status()
            except (SimError, TimeoutError):
                return None

        statuses = [s for s in await gather(
            *[loop.spawn(ask(n)) for n in sorted(self.members)])
            if s is not None]
        if not statuses:
            return []
        best = max(statuses, key=lambda s: s["raft-term"])
        return [best["leader"]] if best.get("leader") else []

    # ---- membership (db.clj:128-190) ---------------------------------------

    async def grow(self, test: dict) -> str:
        """Add a fresh node via a random current member and start it."""
        cluster: Cluster = test["cluster"]
        loop = current_loop()
        self.next_node_id += 1
        new = f"n{self.next_node_id}"
        via = loop.rng.choice(sorted(self.members))
        c = DirectClient(cluster, via)
        await c.add_member(new)
        members = sorted(self.members | {new})
        cluster.start_node(new, fresh=True, initial_membership=members)
        self.members.add(new)
        return new

    async def shrink(self, test: dict) -> str:
        """Remove a random member via another member; kill and wipe it."""
        cluster: Cluster = test["cluster"]
        loop = current_loop()
        if len(self.members) <= 1:
            raise SimError("unhealthy-cluster", "cannot shrink to zero")
        victim = loop.rng.choice(sorted(self.members))
        others = sorted(self.members - {victim})
        via = loop.rng.choice(others)
        c = DirectClient(cluster, via)
        await c.remove_member(victim)
        cluster.kill_node(victim)
        cluster.wipe_node(victim)
        self.members.discard(victim)
        return victim


def db(opts: dict) -> Db:
    return Db(opts)
