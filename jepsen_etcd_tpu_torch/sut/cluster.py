"""The simulated etcd cluster: replicated MVCC over a raft-style log.

This is the system-under-test substrate replacing the reference's real
5-node etcd cluster (``db.clj`` installs/starts real binaries; we simulate).
Faithfulness targets (SURVEY §2.2 "etcd server" row):

- **Consensus**: leader election with the Raft voting restriction (votes
  only for candidates with an up-to-date log) and the leader-commits-only-
  its-own-term rule (noop entry on election), so the cluster is
  linearizable by default — the register workload must PASS against a
  healthy or crash-faulted cluster, and genuinely LOSE data only in the
  scenarios real etcd does (e.g. majority kill with lazyfs-style loss of
  unfsynced WAL tail, cf. db.clj:264-267).
- **Durability model**: per-node WAL + snapshot byte buffers with record
  CRCs (wal.py). With ``unsafe_no_fsync`` (the reference passes
  ``--unsafe-no-fsync``, db.clj:88) appends are durable only up to the
  last snapshot/fsync; a lazyfs kill drops the unfsynced tail. Corruption
  faults flip bits / truncate these buffers; replay panics on a damaged
  committed record (log-file-pattern checker bait, etcd.clj:134-140).
- **Client semantics**: linearizable ops execute at the leader (followers
  forward); serializable reads are node-local (stale under partition);
  leases are leader-timed and reset to full TTL on leader change (the
  etcd behavior that makes locks unsafe, lock.clj); watches stream each
  node's *applied* events in revision order.
- **Faults**: kill/start (with optional lost unfsynced writes), pause/
  resume (SIGSTOP: node unreachable, connections hang), partitions
  (node<->node only; clients always reach nodes, like jepsen's control
  node), clock skew (shifts lease expiry), membership add/remove,
  WAL/snapshot corruption, compaction, defrag.

Everything runs on the deterministic virtual-time loop.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..runner.sim import SimLoop, Future, Event as SimEvent, SECOND
from .errors import SimError
from .store import Store, Txn, Event
from . import wal as walmod

logger = logging.getLogger("jepsen_etcd_tpu_torch.sut")

MS = 1_000_000  # virtual ns


def member_id(name: str) -> int:
    """Stable 64-bit member id for a node name (etcd derives member ids
    by hashing peer URLs; grow always mints fresh names, so a name-hash
    is equally unique and — unlike real etcd — reproducible across
    seeds)."""
    import hashlib
    return int.from_bytes(
        hashlib.sha1(name.encode()).digest()[:8], "big") & (2 ** 63 - 1)


@dataclass
class ClusterConfig:
    election_timeout: int = 1000 * MS     # etcd default 1s
    heartbeat_interval: int = 100 * MS    # etcd default 100ms
    repl_delay: tuple = (1 * MS, 5 * MS)  # node->node replication latency
    rpc_delay: tuple = (1 * MS, 3 * MS)   # client->node latency (per leg)
    snapshot_count: int = 100             # reference stress default
    unsafe_no_fsync: bool = False         # etcd default: fsync on; the
                                          # reference flips it only when
                                          # --unsafe-no-fsync is passed
                                          # (etcd.clj:204, db.clj:96)
    lazyfs: bool = False                  # lose unfsynced writes on kill
    corrupt_check: bool = False           # record per-node state hashes at
                                          # fixed applied indexes so the
                                          # corruption monitor can compare
                                          # them (etcd.clj:164, db.clj:97-99)
    tick: int = 50 * MS                   # scheduler granularity


#: with corrupt_check, fingerprint the applied store at every multiple of
#: this applied index — all nodes hash at the SAME indexes, the analog of
#: etcd's hashKV-at-compact-revision peer comparison
FP_EVERY = 64
#: bound the per-node fingerprint ledger
FP_LEDGER_MAX = 256


@dataclass
class LogEntry:
    index: int
    term: int
    kind: str      # "txn" | "noop" | "compact" | "member_add" |
                   # "member_remove" | "lease_grant" | "lease_revoke"
    payload: Any = None


class Node:
    def __init__(self, name: str, cluster: "Cluster", membership: list):
        self.name = name
        self.cluster = cluster
        self.alive = False
        self.paused = False
        self.removed = False
        self.clock_offset = 0
        # raft volatile
        self.term = 0
        self.voted_for: Optional[str] = None
        self.role = "follower"
        self.leader_hint: Optional[str] = None
        self.election_deadline = 0
        self.last_quorum_contact = 0
        # campaign state (message-level elections): votes received for
        # the current campaign; campaign_id guards stale vote responses
        self.votes: set = set()
        self.campaign_id = 0
        # log: entries [log_start..]; index 0 is a sentinel before start
        self.log: list[LogEntry] = []
        self.log_start = 1      # raft index of log[0]
        self.snap_index = 0
        self.snap_term = 0
        self.commit_index = 0
        self.store = Store()
        self.membership: list[str] = list(membership)
        self.leases: dict[int, int] = {}     # lease id -> ttl (applied state)
        # leader volatile
        self.send_inflight: set = set()  # peers with a sleeping _send_append
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self.lease_expiry: dict[int, int] = {}
        self.waiters: dict[int, tuple[int, Future]] = {}  # index->(term,fut)
        # durability ("files" on disk). RecordFiles hold records as
        # objects and only materialize framed CRC bytes when a
        # corruption fault touches them — value-carrying records made
        # per-append pickling O(history²) on append-heavy workloads
        self.wal = walmod.RecordFile()
        self.snap = walmod.RecordFile()
        self.applied_since_snap = 0
        # observability
        self.etcd_log: list[str] = []
        self.resume_event: Optional[SimEvent] = None
        self.watchers: list = []  # Watcher objects served by this node
        self.store_applied_index = 0
        # corrupt-check: applied index -> state fingerprint, recorded at
        # FP_EVERY multiples (deterministic apply means every healthy
        # node records the same value at the same index)
        self.fp_ledger: dict[int, int] = {}

    # ---- small helpers ----------------------------------------------------

    @property
    def loop(self) -> SimLoop:
        return self.cluster.loop

    def clock(self) -> int:
        return self.loop.now + self.clock_offset

    def log_line(self, msg: str) -> None:
        self.etcd_log.append(
            f"{{\"ts\":{self.loop.now / SECOND:.3f},\"msg\":{msg!r}}}")

    def last_index(self) -> int:
        return self.log_start + len(self.log) - 1 if self.log else self.snap_index

    def last_term(self) -> int:
        return self.log[-1].term if self.log else self.snap_term

    def entry(self, index: int) -> Optional[LogEntry]:
        i = index - self.log_start
        return self.log[i] if 0 <= i < len(self.log) else None

    def majority(self) -> int:
        return len(self.membership) // 2 + 1

    def reset_election_deadline(self) -> None:
        jitter = self.loop.rng.randint(0, self.cluster.cfg.election_timeout)
        self.election_deadline = (self.loop.now +
                                  self.cluster.cfg.election_timeout + jitter)

    # ---- durability -------------------------------------------------------

    def wal_append(self, e: LogEntry) -> None:
        # fsync-per-append unless --unsafe-no-fsync, as etcd does
        self.wal.append((e.index, e.term, e.kind, e.payload),
                        sync=not self.cluster.cfg.unsafe_no_fsync)

    def wal_rewrite(self, entries: list) -> None:
        """Wholesale WAL rewrite (conflict truncation, recovery
        re-encode): fsynced like etcd's unless --unsafe-no-fsync."""
        self.wal.set_records(
            [(e.index, e.term, e.kind, e.payload) for e in entries],
            sync=not self.cluster.cfg.unsafe_no_fsync)

    def fsync(self) -> None:
        self.wal.fsync()
        self.snap.fsync()

    def maybe_snapshot(self) -> None:
        if self.applied_since_snap < self.cluster.cfg.snapshot_count:
            return
        applied = self.commit_index
        self.snap_index = applied
        ent = self.entry(applied)
        self.snap_term = ent.term if ent else self.term
        snap = (applied, self.snap_term, self.store.clone(),
                list(self.membership), dict(self.leases))
        self.snap.set_records([snap], sync=True)
        # drop the log prefix; rebuild the WAL from the snapshot point
        keep = self.log[max(0, applied + 1 - self.log_start):]
        self.log = keep
        self.log_start = applied + 1
        self.wal_rewrite(keep)
        self.fsync()  # etcd fsyncs snapshots even with --unsafe-no-fsync
        self.applied_since_snap = 0
        self.log_line(f"saved snapshot at index {applied}")

    # ---- state machine ----------------------------------------------------

    def apply_up_to_commit(self) -> None:
        while self.store_applied_index < self.commit_index:
            idx = self.store_applied_index + 1
            e = self.entry(idx)
            if e is None:
                break  # entry compacted away / missing (snapshot pending)
            self._apply(e)
            self.store_applied_index = idx
            self.applied_since_snap += 1
            if self.cluster.cfg.corrupt_check and idx % FP_EVERY == 0:
                self.fp_ledger[idx] = self.store.state_fingerprint()
                while len(self.fp_ledger) > FP_LEDGER_MAX:
                    self.fp_ledger.pop(next(iter(self.fp_ledger)))
        self.maybe_snapshot()

    def _apply(self, e: LogEntry) -> None:
        result = None
        if e.kind == "txn":
            result = self.store.apply_txn(e.payload)
            if result["events"]:
                self._notify_watchers(result["events"])
        elif e.kind == "compact":
            try:
                self.store.compact(e.payload)
            except SimError:
                pass
        elif e.kind == "member_add":
            if e.payload not in self.membership:
                self.membership.append(e.payload)
            self.log_line(f"added member {e.payload}")
        elif e.kind == "member_remove":
            if e.payload in self.membership:
                self.membership.remove(e.payload)
            self.log_line(f"removed member {e.payload}")
            if e.payload == self.name:
                self.removed = True
                self.role = "follower"
            else:
                # conf-change broadcast: the removed member learns and
                # shuts its raft ("raft: stopped", client.clj:322-323)
                victim = self.cluster.nodes.get(e.payload)
                if victim is not None and victim.alive:
                    victim.removed = True
                    victim.role = "follower"
                    victim.membership = [m for m in victim.membership
                                         if m != e.payload]
                    victim.log_line("raft: stopped (removed from cluster)")
        elif e.kind == "lease_grant":
            lid, ttl = e.payload
            self.leases[lid] = ttl
            if self.role == "leader":
                self.lease_expiry.setdefault(lid, self.clock() + ttl)
        elif e.kind == "lease_revoke":
            lid = e.payload
            self.leases.pop(lid, None)
            self.lease_expiry.pop(lid, None)
            keys = sorted(self.store.lease_keys.get(lid, set()))
            if keys:
                res = self.store.apply_txn(
                    Txn((), tuple(("delete", k) for k in keys), ()))
                if res["events"]:
                    self._notify_watchers(res["events"])
            self.store.lease_keys.pop(lid, None)
        # resolve the proposer's waiter
        w = self.waiters.pop(e.index, None)
        if w is not None:
            wterm, fut = w
            if wterm == e.term:
                fut.set_result(result)
            else:
                fut.set_exception(SimError("leader-changed",
                                           "entry overwritten"))

    def _notify_watchers(self, events: list[Event]) -> None:
        for w in list(self.watchers):
            w.feed(events)

class Watcher:
    """A watch stream served by one node (client.clj:663-693 surface)."""

    def __init__(self, node: Node, key: str, from_rev: int,
                 on_events: Callable, on_error: Callable,
                 prefix: bool = False):
        self.node = node
        self.key = key
        self.prefix = prefix
        self.next_rev = from_rev
        self.on_events = on_events
        self.on_error = on_error
        self.closed = False
        # A watch is ONE ordered stream: deliveries form a FIFO chain so
        # random per-batch latencies can never reorder events
        # (the nonmonotonic-revision check at watch.clj:161-177 relies on
        # stream order; reordering here would be a false SUT bug).
        self._outbox: list[list[Event]] = []
        self._draining = False

    def matches(self, ev: Event) -> bool:
        return (ev.key.startswith(self.key) if self.prefix
                else ev.key == self.key)

    def feed(self, events: list[Event]) -> None:
        if self.closed:
            return
        evs = [e for e in events
               if self.matches(e) and e.revision >= self.next_rev]
        if not evs:
            return
        self.next_rev = max(e.revision for e in evs) + 1
        self._outbox.append(evs)
        if not self._draining:
            self._draining = True
            delay = self.node.cluster.msg_delay(
                self.node.cluster.cfg.rpc_delay)
            self.node.loop.call_later(delay, self._drain)

    def _drain(self) -> None:
        if self.closed or not self.node.alive:
            self._draining = False
            return  # stream broken; kill_node cancels with an error
        if self.node.paused:
            # SIGSTOP: the kernel buffers the stream; deliver after resume.
            self.node.loop.call_later(self.node.cluster.cfg.tick,
                                      self._drain)
            return
        while self._outbox:
            self.on_events(self._outbox.pop(0))
        self._draining = False

    def cancel(self, error: Optional[SimError] = None) -> None:
        if self.closed:
            return
        self.closed = True
        if self in self.node.watchers:
            self.node.watchers.remove(self)
        if error is not None:
            self.on_error(error)


class Cluster:
    """The simulated cluster + fault API. One instance per test."""

    def __init__(self, loop: SimLoop, node_names: list[str],
                 cfg: Optional[ClusterConfig] = None):
        self.loop = loop
        self.cfg = cfg or ClusterConfig()
        self.initial_names = list(node_names)
        self.nodes: dict[str, Node] = {
            n: Node(n, self, node_names) for n in node_names}
        # blocked link set: frozensets block both directions, ordered
        # (src, dst) tuples block only src -> dst (one-way partitions —
        # the same encoding net/plane.py uses in local mode)
        self.blocked_pairs: set = set()
        # (lo_ns, hi_ns) extra per-message-leg delay when a latency
        # fault is active; None = no fault and NO extra rng draw, so
        # fault-free seeded histories stay bit-identical
        self.net_latency: Optional[tuple[int, int]] = None
        self.running = False
        self._tick_task = None
        self.next_lease_id = 0x70000000
        self.tracer = None  # runner.trace.NetTrace when --tcpdump is set
        # corrupt-check monitor state: confirmed divergences + dedupe keys
        self.corruption_alarms: list[dict] = []
        self._alarm_keys: set = set()

    def _trace(self, kind: str, src: str, dst: str, **info: Any) -> None:
        if self.tracer is not None:
            self.tracer.record(kind, src, dst, **info)

    # ---- lifecycle --------------------------------------------------------

    def launch(self) -> None:
        self.running = True
        for n in self.nodes.values():
            if not n.alive:
                self.start_node(n.name, fresh=True)
        self._tick_task = self.loop.spawn(self._tick_loop(), "cluster-tick")

    def shutdown(self) -> None:
        self.running = False
        for n in self.nodes.values():
            n.alive = False

    async def _tick_loop(self) -> None:
        while self.running:
            await self.loop.sleep(self.cfg.tick)
            for n in list(self.nodes.values()):
                if not n.alive or n.paused or n.removed:
                    continue
                if n.role == "leader":
                    self._leader_tick(n)
                elif self.loop.now >= n.election_deadline:
                    self._start_election(n)

    # ---- connectivity -----------------------------------------------------

    def reachable(self, a: str, b: str) -> bool:
        """Can a message leg travel a -> b right now? Callers pass the
        actual direction per leg (request legs src->dst, response legs
        dst->src), so one-way blocks drop exactly one side."""
        if a == b:
            return True
        na, nb = self.nodes.get(a), self.nodes.get(b)
        if na is None or nb is None:
            return False
        if not (na.alive and nb.alive) or na.paused or nb.paused:
            return False
        return (frozenset((a, b)) not in self.blocked_pairs
                and (a, b) not in self.blocked_pairs)

    def msg_delay(self, base: tuple) -> int:
        """One message-leg delay draw. The injected-latency draw
        happens ONLY while a latency fault is active: the rng stream of
        fault-free runs is untouched (same-seed bit-identity)."""
        d = self.loop.rng.randint(*base)
        if self.net_latency is not None:
            d += self.loop.rng.randint(*self.net_latency)
        return d

    def visible_majority(self, node: Node) -> bool:
        peers = [m for m in node.membership]
        up = sum(1 for m in peers if self.reachable(node.name, m))
        return up >= node.majority()

    # ---- elections & replication ------------------------------------------

    def _start_election(self, cand: Node) -> None:
        """Campaign via message-delayed RequestVote RPCs.

        Requests and responses travel as separate delayed messages (like
        ``_send_append``), so split votes, stale candidates, interleaved
        campaigns, and vote messages lost to partitions/kills all occur —
        the raft schedule surface the reference gets for free by running
        real etcd (db.clj:72-100). The RPC carries the candidate's log
        position captured at send time, per the raft paper.
        """
        cand.term += 1
        cand.voted_for = cand.name
        cand.role = "candidate"
        cand.reset_election_deadline()
        cand.campaign_id += 1
        cand.votes = {cand.name}
        cand.log_line(f"campaigning at term {cand.term}")
        last_term, last_index = cand.last_term(), cand.last_index()
        for m in cand.membership:
            if m == cand.name:
                continue
            self.loop.spawn(
                self._request_vote(cand, m, cand.term, cand.campaign_id,
                                   last_term, last_index), "vote")
        if len(cand.votes) >= cand.majority():   # single-node cluster
            self._become_leader(cand)

    async def _request_vote(self, cand: Node, peer_name: str, term: int,
                            campaign_id: int, last_term: int,
                            last_index: int) -> None:
        # request leg: delivered only if both ends are up and connected
        # at arrival time (same drop model as _send_append)
        await self.loop.sleep(self.msg_delay(self.cfg.repl_delay))
        peer = self.nodes.get(peer_name)
        if (peer is None or peer.removed
                or not self.reachable(cand.name, peer_name)):
            self._trace("vote-req", cand.name, peer_name, term=term,
                        delivered=False)
            return
        self._trace("vote-req", cand.name, peer_name, term=term,
                    delivered=True)
        granted = False
        if peer.term <= term:
            if peer.term < term:
                peer.term = term
                peer.voted_for = None
                if peer.role != "follower":
                    peer.role = "follower"
                    peer.log_line(f"stepping down: saw term {term}")
            up_to_date = (last_term, last_index) >= \
                         (peer.last_term(), peer.last_index())
            if peer.voted_for in (None, cand.name) and up_to_date:
                peer.voted_for = cand.name
                peer.reset_election_deadline()
                granted = True
        resp_term = peer.term
        # response leg
        await self.loop.sleep(self.msg_delay(self.cfg.repl_delay))
        delivered = self.reachable(peer_name, cand.name)
        self._trace("vote-resp", peer_name, cand.name, term=resp_term,
                    granted=granted, delivered=delivered)
        if not delivered:
            return
        if resp_term > cand.term:
            # may already have won and accepted proposals: fail their
            # waiters like every other step-down site
            cand.term = resp_term
            cand.role = "follower"
            cand.voted_for = None
            cand.reset_election_deadline()
            self._fail_waiters(cand, SimError(
                "leader-changed", "higher term in vote response"))
            return
        if cand.role != "candidate" or cand.campaign_id != campaign_id \
                or cand.term != term:
            return  # stale response: a newer campaign, or already decided
        if granted:
            cand.votes.add(peer_name)
            if len(cand.votes) >= cand.majority():
                self._become_leader(cand)

    def _become_leader(self, n: Node) -> None:
        n.role = "leader"
        n.leader_hint = n.name
        n.last_quorum_contact = self.loop.now
        n.next_index = {m: n.last_index() + 1 for m in n.membership}
        n.match_index = {m: 0 for m in n.membership}
        # fresh full TTL for every applied lease (etcd leader-change behavior
        # — the reason lock tests must fail, lock.clj)
        n.lease_expiry = {lid: n.clock() + ttl
                          for lid, ttl in n.leases.items()}
        n.log_line(f"elected leader at term {n.term}")
        logger.debug("%s elected leader term %d", n.name, n.term)
        self._append_entry(n, "noop", None)
        self._leader_tick(n)

    def _append_entry(self, leader: Node, kind: str, payload: Any,
                      fut: Optional[Future] = None) -> LogEntry:
        e = LogEntry(index=leader.last_index() + 1, term=leader.term,
                     kind=kind, payload=payload)
        leader.log.append(e)
        leader.wal_append(e)
        if fut is not None:
            leader.waiters[e.index] = (e.term, fut)
        self._replicate_now(leader)
        return e

    def _replicate_now(self, leader: Node) -> None:
        for m in leader.membership:
            if m == leader.name or m in leader.send_inflight:
                # a sender is already sleeping its repl_delay; it reads the
                # log at wake time, so it will carry entries appended now
                continue
            leader.send_inflight.add(m)
            self.loop.spawn(self._send_append(leader, m), "repl")
        self._advance_commit(leader)

    def _leader_tick(self, leader: Node) -> None:
        # check-quorum: a partitioned leader steps down
        if not self.visible_majority(leader):
            if (self.loop.now - leader.last_quorum_contact >
                    self.cfg.election_timeout):
                leader.role = "follower"
                leader.reset_election_deadline()
                leader.log_line("lost quorum; stepping down")
                self._fail_waiters(leader, SimError(
                    "leader-changed", "lost quorum"))
                return
        else:
            leader.last_quorum_contact = self.loop.now
        self._replicate_now(leader)
        self._expire_leases(leader)

    async def _send_append(self, leader: Node, peer_name: str) -> None:
        try:
            await self.loop.sleep(self.msg_delay(self.cfg.repl_delay))
        finally:
            # past the coalescing window: appends after this point need
            # (and will get) a fresh sender. Cleared in finally — a
            # cancel thrown at the sleep suspension point must not leak
            # the coalescing flag, or _replicate_now would never spawn
            # another sender for this peer
            leader.send_inflight.discard(peer_name)
        peer = self.nodes.get(peer_name)
        if (peer is None or leader.role != "leader" or not leader.alive
                or not self.reachable(leader.name, peer_name)
                or peer.removed):
            self._trace("append", leader.name, peer_name, term=leader.term,
                        delivered=False)
            return
        self._trace("append", leader.name, peer_name, term=leader.term,
                    commit=leader.commit_index, delivered=True)
        if peer.term > leader.term:
            leader.term = peer.term
            leader.role = "follower"
            leader.voted_for = None
            self._fail_waiters(leader, SimError("leader-changed",
                                                "higher term seen"))
            return
        if peer.term < leader.term:
            peer.term = leader.term
            peer.voted_for = None
        peer.role = "follower"
        peer.leader_hint = leader.name
        peer.reset_election_deadline()
        ni = leader.next_index.get(peer_name, leader.last_index() + 1)
        if ni < leader.log_start:
            # peer too far behind: install snapshot
            self._install_snapshot(leader, peer)
            ni = leader.log_start
        # log-matching check at ni-1
        prev_idx = ni - 1
        if prev_idx <= peer.snap_index or prev_idx == 0:
            ok = True  # at/below peer's snapshot: that prefix is committed
        else:
            pe = peer.entry(prev_idx)
            if pe is None:
                ok = False  # peer's log too short: back up
            else:
                le = leader.entry(prev_idx)
                expected = le.term if le is not None else (
                    leader.snap_term if prev_idx == leader.snap_index
                    else None)
                ok = expected is not None and pe.term == expected
        if not ok:
            leader.next_index[peer_name] = max(1, ni - 1)
            return
        # append entries from ni (log is contiguous from log_start, so the
        # tail is a slice — a full-log scan here is O(ops^2) over a run)
        entries = leader.log[max(0, ni - leader.log_start):]
        if entries:
            # truncate conflicts
            first = entries[0].index
            conflict = None
            for e in entries:
                pe = peer.entry(e.index)
                if pe is not None and pe.term != e.term:
                    conflict = e.index
                    break
            if conflict is not None:
                kept = [e for e in peer.log if e.index < conflict]
                dropped = [e for e in peer.log if e.index >= conflict]
                peer.log = kept
                for d in dropped:
                    w = peer.waiters.pop(d.index, None)
                    if w is not None:
                        w[1].set_exception(SimError("leader-changed",
                                                    "entry overwritten"))
                peer.wal_rewrite(peer.log)
            for e in entries:
                if peer.entry(e.index) is None:
                    peer.log.append(LogEntry(e.index, e.term, e.kind,
                                             e.payload))
                    peer.wal_append(peer.log[-1])
            leader.next_index[peer_name] = entries[-1].index + 1
            leader.match_index[peer_name] = entries[-1].index
        else:
            leader.match_index[peer_name] = max(
                leader.match_index.get(peer_name, 0),
                min(ni - 1, leader.last_index()))
        # propagate commit index
        self._advance_commit(leader)
        new_commit = min(leader.commit_index, peer.last_index())
        if new_commit > peer.commit_index:
            peer.commit_index = new_commit
            peer.apply_up_to_commit()

    def _install_snapshot(self, leader: Node, peer: Node) -> None:
        self._trace("snapshot", leader.name, peer.name,
                    index=leader.snap_index, delivered=True)
        snap_items, err = leader.snap.read()
        if err or not snap_items:
            # leader snapshot bytes damaged: send live state (etcd would
            # alarm; we keep the cluster moving and log it)
            leader.log_line("snapshot send from live state")
            peer.store = leader.store.clone()
            peer.membership = list(leader.membership)
            peer.leases = dict(leader.leases)
            peer.snap_index, peer.snap_term = leader.store_applied_index, leader.term
            peer.store_applied_index = leader.store_applied_index
            peer.log = []
            peer.log_start = peer.snap_index + 1
            peer.commit_index = peer.snap_index
        else:
            idx, term, store, membership, leases = snap_items[0]
            peer.store = store.clone()
            peer.membership = list(membership)
            peer.leases = dict(leases)
            peer.snap_index, peer.snap_term = idx, term
            peer.store_applied_index = idx
            peer.log = []
            peer.log_start = idx + 1
            peer.commit_index = idx
        # re-save from the received state — snapshot transfer is
        # CRC-verified in etcd, so damaged leader bytes must not propagate
        peer.snap.set_records([
            (peer.snap_index, peer.snap_term, peer.store.clone(),
             list(peer.membership), dict(peer.leases))], sync=True)
        peer.wal.clear()
        peer.fsync()
        peer.applied_since_snap = 0
        peer.log_line(f"installed snapshot at index {peer.snap_index}")
        # a snapshot replaces the store without applying the skipped
        # entries, so sync watchers from the new store's event history
        # (etcd's watchableStore catches unsynced watchers up from the
        # MVCC backend; only compaction can actually lose them events)
        for w in list(peer.watchers):
            try:
                backlog = peer.store.events_since(w.next_rev)
            except SimError as e:
                w.cancel(e)
                continue
            if backlog:
                w.feed(backlog)

    def _advance_commit(self, leader: Node) -> None:
        if leader.role != "leader":
            return
        for idx in range(leader.last_index(), leader.commit_index, -1):
            e = leader.entry(idx)
            if e is None or e.term != leader.term:
                continue  # only commit entries of own term by counting
            votes = 0
            for m in leader.membership:
                if m == leader.name:
                    votes += 1
                elif leader.match_index.get(m, 0) >= idx:
                    votes += 1
            if votes >= leader.majority():
                leader.commit_index = idx
                leader.apply_up_to_commit()
                break

    def _fail_waiters(self, n: Node, err: SimError) -> None:
        for idx, (_, fut) in list(n.waiters.items()):
            fut.set_exception(err)
        n.waiters.clear()

    def _expire_leases(self, leader: Node) -> None:
        now = leader.clock()
        for lid, deadline in list(leader.lease_expiry.items()):
            if now >= deadline and lid in leader.leases:
                leader.lease_expiry.pop(lid, None)
                leader.log_line(f"lease {lid:x} expired")
                self.loop.spawn(self._propose_silent(
                    leader.name, "lease_revoke", lid), "lease-expire")

    async def _propose_silent(self, leader_name: str, kind: str,
                              payload: Any) -> None:
        try:
            await self.propose(leader_name, kind, payload)
        except SimError:
            pass

    # ---- proposals (leader-side) ------------------------------------------

    async def propose(self, node_name: str, kind: str, payload: Any) -> Any:
        """Propose an entry at node (must be leader); resolves at apply."""
        n = self.nodes[node_name]
        if n.role != "leader" or not n.alive:
            raise SimError("not-leader", node_name)
        fut = self.loop.future()
        self._append_entry(n, kind, payload, fut)
        return await fut

    def current_leader_visible(self, from_node: Node) -> Optional[Node]:
        """The leader as discoverable from this node (via its raft links)."""
        # direct knowledge
        for name in [from_node.leader_hint] + list(from_node.membership):
            if name is None:
                continue
            ln = self.nodes.get(name)
            if (ln is not None and ln.alive and not ln.paused
                    and ln.role == "leader"
                    and self.reachable(from_node.name, name)):
                return ln
        return None

    # ---- client RPC surface ------------------------------------------------

    async def _enter(self, node_name: str) -> Node:
        """Client dial + request leg."""
        n = self.nodes.get(node_name)
        if n is None:
            raise SimError("unavailable", f"unknown node {node_name}")
        await self.loop.sleep(self.msg_delay(self.cfg.rpc_delay))
        if not n.alive:
            raise SimError("connect-failed", node_name)
        if n.removed:
            raise SimError("raft-stopped", node_name)
        if n.paused:
            # SIGSTOP: the TCP connection hangs; wait for resume
            if n.resume_event is None:
                n.resume_event = SimEvent(self.loop)
            await n.resume_event.wait()
            if not n.alive:
                raise SimError("connect-failed", node_name)
        return n

    async def _at_leader(self, node: Node) -> Node:
        """Forward to the leader, waiting through elections (until the
        caller's timeout cancels us)."""
        while True:
            if node.role == "leader":
                return node
            leader = self.current_leader_visible(node)
            if leader is not None:
                await self.loop.sleep(self.msg_delay(self.cfg.repl_delay))
                return leader
            await self.loop.sleep(self.cfg.heartbeat_interval)
            if not node.alive:
                raise SimError("unavailable", node.name)

    async def kv_txn(self, node_name: str, txn: Txn) -> dict:
        """Linearizable If/Then/Else transaction (client.clj:464-485)."""
        n = await self._enter(node_name)
        leader = await self._at_leader(n)
        result = await self.propose(leader.name, "txn", txn)
        await self.loop.sleep(self.msg_delay(self.cfg.rpc_delay))
        return result

    async def kv_read(self, node_name: str, key: str,
                      serializable: bool = False) -> dict:
        """Reads: serializable = node-local (stale allowed, register.clj:26-28
        with :serializable); default linearizable via leader read-index."""
        n = await self._enter(node_name)
        if serializable:
            return {"kv": n.store.get(key), "revision": n.store.revision}
        leader = await self._at_leader(n)
        await self._read_index(leader)
        out = {"kv": leader.store.get(key), "revision": leader.store.revision}
        await self.loop.sleep(self.msg_delay(self.cfg.rpc_delay))
        return out

    def _committed_own_term(self, leader: Node) -> bool:
        """Has this leader committed an entry of its OWN term? Until the
        election noop commits, the leader's commit_index may lag entries
        the PREVIOUS leader already acked (they are in this log by the
        election restriction, but commit knowledge travels with later
        appends) — serving reads before then returns applied state from
        before those acks: a stale linearizable read. etcd refuses
        ReadIndex until then (raft §8 / etcd server apply loop); found
        in-harness by the register checker as a real violation (r5): a
        2.3 s stale window after a kill+partition churn."""
        ci = leader.commit_index
        if ci <= leader.snap_index:
            term = leader.snap_term if ci == leader.snap_index else 0
        else:
            e = leader.entry(ci)
            term = e.term if e is not None else 0
        return term == leader.term

    async def _read_index(self, leader: Node) -> None:
        """Quorum round before serving a linearizable read.

        This is a real heartbeat exchange, not just a reachability count:
        each contacted peer reports its term, so a stale leader (e.g. one
        just resumed from SIGSTOP while a successor was elected) is deposed
        here instead of serving a stale read as linearizable. A NEW
        leader additionally refuses until its own-term noop commits
        (_committed_own_term) — before that its applied state may miss
        entries its predecessor acked.
        """
        while True:
            await self.loop.sleep(self.msg_delay(self.cfg.repl_delay))
            if not leader.alive:
                raise SimError("unavailable", leader.name)
            if leader.role != "leader":
                raise SimError("leader-changed", leader.name)
            if not self._committed_own_term(leader):
                await self.loop.sleep(self.cfg.heartbeat_interval)
                continue
            acks = 0
            for m in leader.membership:
                if m == leader.name:
                    acks += 1
                    continue
                peer = self.nodes.get(m)
                if peer is None or not self.reachable(leader.name, m):
                    continue
                if peer.term > leader.term:
                    leader.term = peer.term
                    leader.role = "follower"
                    leader.voted_for = None
                    self._fail_waiters(leader, SimError(
                        "leader-changed", "higher term seen on read-index"))
                    raise SimError("leader-changed", leader.name)
                acks += 1
            if acks >= leader.majority():
                return
            await self.loop.sleep(self.cfg.heartbeat_interval)

    async def range_read(self, node_name: str, prefix: str,
                         serializable: bool = False) -> list[dict]:
        n = await self._enter(node_name)
        if serializable:
            return n.store.range_prefix(prefix)
        leader = await self._at_leader(n)
        await self._read_index(leader)
        return leader.store.range_prefix(prefix)

    # ---- leases ------------------------------------------------------------

    async def lease_grant(self, node_name: str, ttl_ns: int) -> int:
        n = await self._enter(node_name)
        leader = await self._at_leader(n)
        self.next_lease_id += self.loop.rng.randint(1, 1000)
        lid = self.next_lease_id
        await self.propose(leader.name, "lease_grant", (lid, ttl_ns))
        return lid

    async def lease_revoke(self, node_name: str, lid: int) -> None:
        n = await self._enter(node_name)
        leader = await self._at_leader(n)
        if lid not in leader.leases:
            raise SimError("lease-not-found", f"{lid:x}")
        await self.propose(leader.name, "lease_revoke", lid)

    async def lease_keepalive(self, node_name: str, lid: int) -> int:
        """Refresh; returns granted ttl (client.clj:544-554 keepalive)."""
        n = await self._enter(node_name)
        leader = await self._at_leader(n)
        ttl = leader.leases.get(lid)
        if ttl is None:
            raise SimError("lease-not-found", f"{lid:x}")
        leader.lease_expiry[lid] = leader.clock() + ttl
        return ttl

    # ---- locks (etcd lock service semantics) --------------------------------

    async def lock(self, node_name: str, name: str, lid: int) -> str:
        """Acquire: create name/<lease> key, wait until first in queue."""
        n = await self._enter(node_name)
        leader = await self._at_leader(n)
        if lid not in leader.leases:
            raise SimError("lease-not-found", f"{lid:x}")
        key = f"__lock__/{name}/{lid:x}"
        await self.propose(leader.name, "txn", Txn(
            cmps=(("=", key, "version", 0),),
            then_ops=(("put", key, lid, lid),),
            else_ops=(("get", key),)))
        while True:
            waiters = await self.range_read(node_name,
                                           f"__lock__/{name}/")
            mine = [kv for kv in waiters if kv["key"] == key]
            if not mine:
                raise SimError("lease-not-found",
                               f"lock key lost (lease {lid:x} expired?)")
            if min(waiters, key=lambda kv: kv["create-revision"])["key"] == key:
                return key
            await self.loop.sleep(self.cfg.heartbeat_interval)

    async def unlock(self, node_name: str, lock_key: str) -> None:
        n = await self._enter(node_name)
        leader = await self._at_leader(n)
        res = await self.propose(leader.name, "txn",
                                 Txn((), (("delete", lock_key),), ()))
        deleted = res["results"][0][1]
        if not deleted:
            raise SimError("not-held", lock_key)

    # ---- watches ------------------------------------------------------------

    def watch(self, node_name: str, key: str, from_rev: int,
              on_events: Callable, on_error: Callable) -> Watcher:
        """Open a watch stream on a node from a revision
        (client.clj:663-693). Synchronous registration; catch-up events
        are delivered asynchronously."""
        n = self.nodes.get(node_name)
        if n is None or not n.alive:
            raise SimError("connect-failed", node_name)
        w = Watcher(n, key, from_rev, on_events, on_error)
        try:
            backlog = n.store.events_since(from_rev)
        except SimError as e:
            self.loop.call_soon(on_error, e)
            return w
        n.watchers.append(w)
        if backlog:
            w.next_rev = max(e.revision for e in backlog) + 1
            w._outbox.append(backlog)
            w._draining = True
            delay = self.msg_delay(self.cfg.rpc_delay)
            self.loop.call_later(delay, w._drain)
        return w

    # ---- maintenance / status ----------------------------------------------

    async def status(self, node_name: str) -> dict:
        n = await self._enter(node_name)
        return {
            "node": n.name,
            "leader": n.leader_hint,
            "raft-term": n.term,
            "raft-index": n.last_index(),
            "revision": n.store.revision,
            "db-size": n.wal.size + n.snap.size,
            "member-count": len(n.membership),
            "is-leader": n.role == "leader",
        }

    async def compact(self, node_name: str, rev: int,
                      physical: bool = False) -> None:
        n = await self._enter(node_name)
        leader = await self._at_leader(n)
        if rev <= leader.store.compact_revision:
            raise SimError("compacted", f"{rev} already compacted")
        if rev > leader.store.revision:
            raise SimError("compacted", f"{rev} is a future revision")
        await self.propose(leader.name, "compact", rev)
        if physical:
            await self.loop.sleep(10 * MS)

    async def defrag(self, node_name: str) -> None:
        n = await self._enter(node_name)
        await self.loop.sleep(self.loop.rng.randint(50 * MS, 200 * MS))
        n.log_line("defragmented")

    # ---- membership ---------------------------------------------------------

    async def member_list(self, node_name: str) -> list[dict]:
        """Member maps with etcd-style ids and URLs (client.clj:571-613;
        URL scheme peer 2380 / client 2379 per support.clj:12-25)."""
        n = await self._enter(node_name)
        return [{"id": member_id(m), "name": m,
                 "peer-urls": [f"http://{m}:2380"],
                 "client-urls": [f"http://{m}:2379"]}
                for m in n.membership]

    async def member_add(self, via_node: str, new_name: str) -> None:
        n = await self._enter(via_node)
        leader = await self._at_leader(n)
        if new_name in leader.membership:
            raise SimError("duplicate-key", new_name)
        await self.propose(leader.name, "member_add", new_name)

    async def member_remove(self, via_node: str, name: str) -> None:
        n = await self._enter(via_node)
        leader = await self._at_leader(n)
        if name not in leader.membership:
            raise SimError("member-not-found", name)
        await self.propose(leader.name, "member_remove", name)

    # ---- fault API (driven by the nemesis / db layers) ----------------------

    def kill_node(self, name: str, lose_unfsynced: bool = False) -> None:
        n = self.nodes[name]
        if not n.alive:
            return
        n.alive = False
        n.paused = False
        n.role = "follower"
        n.log_line("received signal; shutting down (killed)")
        self._fail_waiters(n, SimError("unavailable", "node killed"))
        for w in list(n.watchers):
            w.cancel(SimError("unavailable", "node killed"))
        if lose_unfsynced or (self.cfg.lazyfs and self.cfg.unsafe_no_fsync):
            n.wal.lose_unfsynced()
            n.snap.lose_unfsynced()
        if n.resume_event is not None:
            n.resume_event.set()
            n.resume_event = None

    def start_node(self, name: str, fresh: bool = False,
                   initial_membership: Optional[list] = None) -> None:
        """(Re)start a node, recovering from its durable files.

        Raises SimError("corrupt") and logs a panic if the WAL or snapshot
        bytes are damaged in a committed region.
        """
        n = self.nodes.get(name)
        if n is None:
            n = Node(name, self,
                     initial_membership or self.initial_names)
            self.nodes[name] = n
        if n.alive:
            return
        if fresh:
            n.wal.clear()
            n.snap.clear()
            n.log = []
            n.log_start = 1
            n.snap_index = n.snap_term = 0
            n.store = Store()
            n.store_applied_index = 0
            n.commit_index = 0
            n.term = 0
            n.membership = list(initial_membership or self.initial_names)
            n.leases = {}
            n.fp_ledger = {}
        else:
            self._recover(n)
        n.alive = True
        n.paused = False
        n.removed = name not in n.membership
        n.role = "follower"
        if fresh:
            n.voted_for = None   # non-fresh restarts keep HardState vote
        n.leader_hint = None
        n.waiters = {}
        n.watchers = []
        n.applied_since_snap = 0
        n.reset_election_deadline()
        n.log_line("etcd server started")

    def _recover(self, n: Node) -> None:
        # ledger restarts with the replay: re-applied entries re-record
        # the same fingerprints at the same indexes (deterministic apply),
        # while a silently-damaged snapshot diverges and gets caught
        n.fp_ledger = {}
        # snapshot
        snap_items, snap_err = n.snap.read()
        if snap_err == "crc-mismatch":
            n.log_line("panic: snap: crc mismatch, cannot load snapshot")
            raise SimError("corrupt", f"{n.name} snapshot corrupt")
        if snap_items:
            idx, term, store, membership, leases = snap_items[0]
            n.store = store.clone()
            n.membership = list(membership)
            n.leases = dict(leases)
            n.snap_index, n.snap_term = idx, term
            n.store_applied_index = idx
            n.log_start = idx + 1
        else:
            n.store = Store()
            n.store_applied_index = 0
            n.snap_index = n.snap_term = 0
            n.log_start = 1
            n.membership = list(self.initial_names)
            n.leases = {}
        # wal
        items, err = n.wal.read()
        if err == "crc-mismatch":
            n.log_line("panic: walpb: crc mismatch")
            raise SimError("corrupt", f"{n.name} WAL corrupt")
        # torn-record at the tail is tolerated (mid-write crash)
        n.log = [LogEntry(i, t, k, p) for (i, t, k, p) in items
                 if i >= n.log_start]
        n.wal_rewrite(n.log)
        # HardState: etcd persists (term, vote) in its WAL and fsyncs it
        # before answering RPCs, so a restarted voter can never re-grant
        # its vote in the same term (raft election safety). We model the
        # hard state as surviving in the Node object across kill/restart
        # (n.term / n.voted_for are simply not cleared); the log-derived
        # term below is only a floor for nodes whose object predates the
        # campaign.
        n.term = max([n.term, n.snap_term] + [e.term for e in n.log])
        # conservative: nothing beyond the snapshot is known committed;
        # the leader's replication will re-advance commit_index.
        n.commit_index = n.snap_index

    def pause_node(self, name: str) -> None:
        n = self.nodes[name]
        if n.alive:
            n.paused = True
            # NOTE: real etcd logs nothing while stopped (the process is
            # frozen); keep the sim marker free of SIG[A-Z]+ so the
            # crash-pattern checker (etcd.clj:134-140) can't false-match
            n.log_line("paused (stop signal)")

    def resume_node(self, name: str) -> None:
        n = self.nodes[name]
        n.paused = False
        n.log_line("resumed (cont signal)")
        if n.resume_event is not None:
            n.resume_event.set()
            n.resume_event = None
        n.reset_election_deadline()

    def partition(self, groups: list[list[str]]) -> None:
        """Partition nodes into isolated groups."""
        self.blocked_pairs = set()
        group_of = {}
        for gi, g in enumerate(groups):
            for name in g:
                group_of[name] = gi
        names = list(self.nodes)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                if group_of.get(a) != group_of.get(b):
                    self.blocked_pairs.add(frozenset((a, b)))

    def partition_pairs(self, pairs) -> None:
        """Install an explicit blocked set: frozensets block both
        directions, ordered (src, dst) tuples block only src -> dst
        (asymmetric partitions; same encoding as net/plane.py)."""
        self.blocked_pairs = set(pairs)

    def heal_partition(self) -> None:
        self.blocked_pairs = set()

    def set_latency(self, delta_ms: float, jitter_ms: float = 0) -> None:
        """Inject delta + U(0, jitter) extra delay on every message
        leg (the sim backend of the latency nemesis package)."""
        lo = int(delta_ms * MS)
        self.net_latency = (lo, lo + int(jitter_ms * MS))

    def clear_latency(self) -> None:
        self.net_latency = None

    def bump_clock(self, name: str, delta_ns: int) -> None:
        self.nodes[name].clock_offset += delta_ns

    def corrupt_file(self, name: str, which: str = "wal",
                     mode: str = "bitflip", probability: float = 1e-4,
                     truncate_bytes: int = 1024) -> None:
        """Damage durable bytes (nemesis.clj:159-198). Materializes the
        file's framed CRC bytes (BYTES mode) so the damage lands on the
        same byte layout real etcd replay would see."""
        n = self.nodes[name]
        f = n.wal if which == "wal" else n.snap
        f.corrupt(self.loop.rng, mode=mode, probability=probability,
                  truncate_bytes=truncate_bytes)
        n.log_line(f"file corrupted: {which} ({mode})")

    def wipe_node(self, name: str) -> None:
        """Remove all durable state (db.clj:29-36 wipe!); the removal is
        itself durable (the reference checkpoints lazyfs right after the
        rm -rf so wiped files can't come back when unsynced writes are
        later dropped)."""
        n = self.nodes[name]
        n.wal.clear()
        n.snap.clear()

    def checkpoint_node(self, name: str) -> None:
        """lazyfs checkpoint! analog (db.clj:35-36): flush current file
        state to durable, pinning it as the rollback floor for future
        lose-unfsynced kills. Called after setup (db.clj:222-223) so a
        kill never rolls a node back past its initial ready state."""
        self.nodes[name].fsync()

    # ---- invariants ---------------------------------------------------------

    def consistency_report(self) -> dict:
        """Cross-node applied-state fingerprint comparison (the analog of
        etcd's corruption alarm)."""
        fps = {}
        for name, n in self.nodes.items():
            fps[name] = {"applied": n.store_applied_index,
                         "revision": n.store.revision,
                         "fingerprint": n.store.state_fingerprint()}
        return fps

    def check_corruption(self) -> list[dict]:
        """The --corrupt-check monitor pass (db.clj:97-99 enables etcd's
        --experimental-initial-corrupt-check / --corrupt-check-time 1m).

        Applied state at a given raft index is a deterministic function of
        the log prefix, so two nodes whose hashes differ at the SAME
        applied index have definitely diverged — the analog of etcd's
        hashKV peer comparison at a shared revision. Compares both the
        FP_EVERY-multiple ledgers and the live stores of nodes that
        happen to sit at equal applied indexes. New divergences are
        alarm-logged at fatal level on both nodes (so LogFilePattern
        catches them, like etcd's "found data inconsistency with peers"
        fatal) and recorded in self.corruption_alarms.
        """
        new: list[dict] = []
        nodes = sorted(self.nodes)
        live_fp = {a: self.nodes[a].store.state_fingerprint()
                   for a in nodes}
        for i, a in enumerate(nodes):
            na = self.nodes[a]
            for b in nodes[i + 1:]:
                nb = self.nodes[b]
                pairs = [(idx, na.fp_ledger[idx], nb.fp_ledger[idx])
                         for idx in na.fp_ledger.keys() & nb.fp_ledger.keys()]
                if (na.store_applied_index == nb.store_applied_index
                        and na.store_applied_index > 0):
                    pairs.append((na.store_applied_index,
                                  live_fp[a], live_fp[b]))
                for idx, fa, fb in pairs:
                    if fa == fb:
                        continue
                    key = (idx, a, b)
                    if key in self._alarm_keys:
                        continue
                    self._alarm_keys.add(key)
                    alarm = {"index": idx, "nodes": [a, b],
                             "fingerprints": [fa, fb],
                             "time": self.loop.now / SECOND}
                    new.append(alarm)
                    for n in (na, nb):
                        n.etcd_log.append(
                            f'{{"ts":{self.loop.now / SECOND:.3f},'
                            f'"level":"fatal","msg":"checkCorrupt: found '
                            f'data inconsistency with peers","index":{idx},'
                            f'"peers":["{a}","{b}"]}}')
        self.corruption_alarms.extend(new)
        return new
