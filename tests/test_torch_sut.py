"""Twin of the reference's ``tests/test_sut.py`` on the port's ``sut/``
(the simulated etcd cluster, the store and the WAL model; copies of the
reference's). Each test runs on both packages (``both``) from the same
seed, with the reference's assertions, and what it observes (results,
reads, revisions, virtual times, logs, file bytes) is equal. One more
test holds the simulated files' bytes equal to the reference's: a
corruption fault's seeded bitflips land on the same record layout."""

import random

import pytest

from test_torch_fixtures import as_json, both, mod
from test_torch_fixtures import one_torch_thread  # noqa: F401

NODES = ["n1", "n2", "n3", "n4", "n5"]


class Pkg:
    """One package's loop, cluster, store and WAL modules."""

    def __init__(self, pkg):
        self.sim = mod(pkg, "runner.sim")
        self.sut = mod(pkg, "sut")
        self.cl = mod(pkg, "sut.cluster")
        self.wal = mod(pkg, "sut.wal")
        self.store = mod(pkg, "sut.store")
        self.SECOND = self.sim.SECOND
        self.MS = self.cl.MS

    def put_txn(self, k, v):
        return self.sut.Txn((), (("put", k, v, 0),), ())

    async def await_leader(self, cluster, timeout_s=10):
        loop = self.sim.current_loop()
        deadline = loop.now + timeout_s * self.SECOND
        while loop.now < deadline:
            leaders = [n for n in cluster.nodes.values()
                       if n.alive and n.role == "leader" and not n.removed]
            if leaders:
                return leaders[0]
            await self.sim.sleep(100 * self.MS)
        raise AssertionError("no leader elected")


def on_cluster(body, seed=7, nodes=NODES, cfg=None):
    """``body(P, loop, cluster)`` on both packages, each on a launched
    cluster as the reference's ``sim`` fixture makes it; returns the
    port's output, equal to the reference's as JSON reads it (results
    hold each package's own ``Event`` objects)."""
    def run(pkg):
        P = Pkg(pkg)
        loop = P.sim.SimLoop(seed=seed)
        P.sim.set_current_loop(loop)
        try:
            cluster = P.sut.Cluster(loop, nodes, *(
                [P.sut.ClusterConfig(**cfg)] if cfg is not None else []))
            cluster.launch()
            out = body(P, loop, cluster)
            cluster.shutdown()
            return as_json(out)
        finally:
            P.sim.set_current_loop(None)
    return both(run)


def on_pkg(body):
    """``body(P)`` on both packages; the outputs are equal as JSON reads
    them."""
    return both(lambda pkg: as_json(body(Pkg(pkg))))


def _election_and_write(P, loop, cluster):
    async def main():
        leader = await P.await_leader(cluster)
        res = await cluster.kv_txn("n1", P.put_txn("foo", 42))
        assert res["succeeded"]
        assert res["revision"] == 2
        out = await cluster.kv_read("n3", "foo")
        assert out["kv"]["value"] == 42
        assert out["kv"]["version"] == 1
        res2 = await cluster.kv_txn("n2", P.put_txn("foo", 43))
        out2 = await cluster.kv_read("n5", "foo")
        assert out2["kv"]["version"] == 2
        assert out2["kv"]["mod-revision"] == 3
        assert out2["kv"]["create-revision"] == 2
        return leader.name, res, out, res2, out2, loop.now

    return loop.run_coro(main())


def test_election_and_write():
    on_cluster(_election_and_write)


def _cas_txn_semantics(P, loop, cluster):
    Txn = P.sut.Txn

    async def main():
        await P.await_leader(cluster)
        await cluster.kv_txn("n1", P.put_txn("k", 1))
        r1 = await cluster.kv_txn("n1", Txn(
            (("=", "k", "value", 1),), (("put", "k", 2, 0),), ()))
        assert r1["succeeded"]
        r2 = await cluster.kv_txn("n1", Txn(
            (("=", "k", "value", 1),), (("put", "k", 3, 0),), ()))
        assert not r2["succeeded"]
        out = await cluster.kv_read("n2", "k")
        assert out["kv"]["value"] == 2
        r3 = await cluster.kv_txn("n1", Txn(
            (("<", "missing", "mod_revision", 100),),
            (("put", "probe", 1, 0),), ()))
        assert r3["succeeded"]
        return r1, r2, out, r3, loop.now

    return loop.run_coro(main())


def test_cas_txn_semantics():
    on_cluster(_cas_txn_semantics)


def _leader_kill_reelection(P, loop, cluster):
    async def main():
        leader = await P.await_leader(cluster)
        await cluster.kv_txn("n1", P.put_txn("a", 1))
        cluster.kill_node(leader.name)
        new_leader = None
        deadline = loop.now + 15 * P.SECOND
        while loop.now < deadline:
            ls = [n for n in cluster.nodes.values()
                  if n.alive and n.role == "leader"]
            if ls and ls[0].name != leader.name:
                new_leader = ls[0]
                break
            await P.sim.sleep(100 * P.MS)
        assert new_leader is not None, "no re-election"
        out = await cluster.kv_read(new_leader.name, "a")
        assert out["kv"]["value"] == 1
        cluster.start_node(leader.name)
        await P.sim.sleep(3 * P.SECOND)
        out2 = await cluster.kv_read(leader.name, "a", serializable=True)
        assert out2["kv"] is not None and out2["kv"]["value"] == 1
        return leader.name, new_leader.name, out, out2, loop.now

    return loop.run_coro(main())


def test_leader_kill_reelection():
    on_cluster(_leader_kill_reelection)


def _partition_minority_unavailable(P, loop, cluster):
    async def main():
        leader = await P.await_leader(cluster)
        others = [n for n in NODES if n != leader.name]
        minority = [leader.name, others[0]]
        majority = others[1:]
        cluster.partition([minority, majority])
        await P.sim.sleep(5 * P.SECOND)
        maj_leaders = [n.name for n in cluster.nodes.values()
                       if n.role == "leader" and n.name in majority]
        assert maj_leaders, "majority failed to elect"
        res = await cluster.kv_txn(majority[0], P.put_txn("p", 9))
        assert res["succeeded"]
        assert cluster.nodes[leader.name].role != "leader"
        t = P.sim.current_loop().spawn(
            cluster.kv_txn(minority[0], P.put_txn("p", 10)))
        with pytest.raises(TimeoutError):
            await P.sim.wait_for(t, 5 * P.SECOND)
        out = await cluster.kv_read(minority[0], "p", serializable=True)
        assert out["kv"] is None
        cluster.heal_partition()
        await P.sim.sleep(3 * P.SECOND)
        out2 = await cluster.kv_read(minority[0], "p", serializable=True)
        assert out2["kv"] is not None and out2["kv"]["value"] == 9
        return maj_leaders, res, out2, loop.now

    return loop.run_coro(main())


def test_partition_minority_unavailable():
    on_cluster(_partition_minority_unavailable)


def _lease_expiry_deletes_keys(P, loop, cluster):
    Txn = P.sut.Txn

    async def main():
        await P.await_leader(cluster)
        lid = await cluster.lease_grant("n1", 2 * P.SECOND)
        await cluster.kv_txn("n1", Txn((), (("put", "locked", 5, lid),), ()))
        out = await cluster.kv_read("n2", "locked")
        assert out["kv"] is not None
        await P.sim.sleep(4 * P.SECOND)
        gone = await cluster.kv_read("n2", "locked")
        assert gone["kv"] is None
        lid2 = await cluster.lease_grant("n1", 2 * P.SECOND)
        await cluster.kv_txn("n1", Txn((), (("put", "ka", 6, lid2),), ()))
        for _ in range(6):
            await P.sim.sleep(1 * P.SECOND)
            await cluster.lease_keepalive("n1", lid2)
        kept = await cluster.kv_read("n2", "ka")
        assert kept["kv"] is not None
        return lid, lid2, out, kept, loop.now

    return loop.run_coro(main())


def test_lease_expiry_deletes_keys():
    on_cluster(_lease_expiry_deletes_keys)


def _lock_mutual_exclusion(P, loop, cluster):
    async def main():
        await P.await_leader(cluster)
        lid1 = await cluster.lease_grant("n1", 30 * P.SECOND)
        lid2 = await cluster.lease_grant("n2", 30 * P.SECOND)
        key1 = await cluster.lock("n1", "mylock", lid1)
        t2 = loop.spawn(cluster.lock("n2", "mylock", lid2))
        await P.sim.sleep(2 * P.SECOND)
        assert not t2.done
        await cluster.unlock("n1", key1)
        key2 = await t2
        assert key2 != key1
        with pytest.raises(P.sut.SimError) as ei:
            await cluster.unlock("n1", key1)
        assert ei.value.type == "not-held"
        await cluster.unlock("n2", key2)
        return key1, key2, str(ei.value), loop.now

    return loop.run_coro(main())


def test_lock_mutual_exclusion():
    on_cluster(_lock_mutual_exclusion)


def _watch_stream_order(P, loop, cluster):
    async def main():
        await P.await_leader(cluster)
        got = []
        w = cluster.watch("n3", "w", 1, lambda evs: got.extend(evs),
                          lambda err: got.append(("error", err)))
        for i in range(5):
            await cluster.kv_txn("n1", P.put_txn("w", i))
        await P.sim.sleep(1 * P.SECOND)
        vals = [e.kv["value"] for e in got if not isinstance(e, tuple)]
        assert vals == [0, 1, 2, 3, 4]
        revs = [e.revision for e in got]
        assert revs == sorted(revs)
        w.cancel()
        return vals, revs, loop.now

    return loop.run_coro(main())


def test_watch_stream_order():
    on_cluster(_watch_stream_order)


def _wal_corruption_panics_on_restart(P, loop, cluster):
    async def main():
        await P.await_leader(cluster)
        for i in range(10):
            await cluster.kv_txn("n1", P.put_txn(f"k{i}", i))
        victim = "n5"
        cluster.kill_node(victim)
        cluster.corrupt_file(victim, which="wal", mode="bitflip",
                             probability=1e-2)
        with pytest.raises(P.sut.SimError) as ei:
            cluster.start_node(victim)
        assert ei.value.type == "corrupt"
        log = list(cluster.nodes[victim].etcd_log)
        assert any("panic" in line for line in log)
        return log, bytes(cluster.nodes[victim].wal._bytes), loop.now

    return loop.run_coro(main())


def test_wal_corruption_panics_on_restart():
    on_cluster(_wal_corruption_panics_on_restart)


def _lazyfs_majority_kill_loses_data(P, loop, cluster):
    async def main():
        await P.await_leader(cluster)
        res = await cluster.kv_txn("n1", P.put_txn("precious", 1))
        assert res["succeeded"]
        for n in NODES:
            cluster.kill_node(n, lose_unfsynced=True)
        for n in NODES:
            cluster.start_node(n)
        await P.await_leader(cluster)
        out = await cluster.kv_read("n1", "precious")
        assert out["kv"] is None
        return res, loop.now

    return loop.run_coro(main())


def test_lazyfs_majority_kill_loses_data():
    """Unfsynced writes on a killed majority vanish; an acknowledged
    write can be lost (db.clj:264-267)."""
    on_cluster(_lazyfs_majority_kill_loses_data, seed=11,
               cfg={"lazyfs": True, "unsafe_no_fsync": True})


def _snapshot_and_catchup(P, loop, cluster):
    async def main():
        await P.await_leader(cluster)
        victim = "n4"
        cluster.kill_node(victim)
        for i in range(150):
            await cluster.kv_txn("n1", P.put_txn(f"s{i % 7}", i))
        cluster.start_node(victim)
        await P.sim.sleep(5 * P.SECOND)
        out = await cluster.kv_read(victim, "s0", serializable=True)
        assert out["kv"] is not None
        await P.sim.sleep(2 * P.SECOND)
        rep = cluster.consistency_report()
        fps = {v["fingerprint"] for k, v in rep.items()
               if cluster.nodes[k].alive}
        assert len(fps) == 1, rep
        return out, rep, loop.now

    return loop.run_coro(main())


def test_snapshot_and_catchup():
    on_cluster(_snapshot_and_catchup)


def _membership_add_remove(P, loop, cluster):
    SimError = P.sut.SimError

    async def main():
        await P.await_leader(cluster)
        await cluster.kv_txn("n1", P.put_txn("m", 1))
        await cluster.member_remove("n1", "n5")
        deadline = loop.now + 15 * P.SECOND
        names = ms = None
        while loop.now < deadline:
            await P.sim.sleep(500 * P.MS)
            try:
                ms = await cluster.member_list("n1")
            except SimError:
                continue
            names = [m["name"] for m in ms]
            if "n5" not in names:
                break
        assert names is not None and "n5" not in names and len(names) == 4
        assert all(isinstance(m["id"], int) and
                   m["peer-urls"] == [f"http://{m['name']}:2380"]
                   for m in ms)
        members = names
        with pytest.raises(SimError) as ei:
            await cluster.kv_txn("n5", P.put_txn("m", 2))
        assert ei.value.type == "raft-stopped"
        await cluster.member_add("n1", "n6")
        cluster.start_node("n6", fresh=True,
                           initial_membership=members + ["n6"])
        await P.sim.sleep(5 * P.SECOND)
        out = await cluster.kv_read("n6", "m", serializable=True)
        assert out["kv"] is not None and out["kv"]["value"] == 1
        return ms, out, loop.now

    return loop.run_coro(main())


def test_membership_add_remove():
    on_cluster(_membership_add_remove)


def _compaction_and_watch_from_compacted(P, loop, cluster):
    async def main():
        await P.await_leader(cluster)
        for i in range(20):
            await cluster.kv_txn("n1", P.put_txn("c", i))
        await cluster.compact("n1", 15, physical=True)
        errors = []
        cluster.watch("n1", "c", 2, lambda evs: None,
                      lambda err: errors.append(err))
        await P.sim.sleep(1 * P.SECOND)
        assert errors and errors[0].type == "compacted"
        return [str(e) for e in errors], loop.now

    return loop.run_coro(main())


def test_compaction_and_watch_from_compacted():
    on_cluster(_compaction_and_watch_from_compacted)


def _determinism_cluster(P):
    def once():
        loop = P.sim.SimLoop(seed=5)
        P.sim.set_current_loop(loop)
        cluster = P.sut.Cluster(loop, NODES)
        cluster.launch()

        async def main():
            await P.await_leader(cluster)
            outs = []
            for i in range(10):
                r = await cluster.kv_txn("n1", P.put_txn("d", i))
                outs.append((r["revision"], loop.now))
            return outs

        out = loop.run_coro(main())
        cluster.shutdown()
        P.sim.set_current_loop(None)
        return out

    first = once()
    assert first == once()
    return first


def test_determinism_cluster():
    on_pkg(_determinism_cluster)


def _resumed_stale_leader(P, loop, cluster):
    SimError = P.sut.SimError

    async def main():
        leader = await P.await_leader(cluster)
        await cluster.kv_txn("n1", P.put_txn("x", 1))
        cluster.pause_node(leader.name)
        deadline = loop.now + 20 * P.SECOND
        new_leader = None
        while loop.now < deadline:
            ls = [n for n in cluster.nodes.values()
                  if n.alive and not n.paused and n.role == "leader"]
            if ls:
                new_leader = ls[0]
                break
            await P.sim.sleep(100 * P.MS)
        assert new_leader is not None
        await cluster.kv_txn(new_leader.name, P.put_txn("x", 2))
        cluster.resume_node(leader.name)
        try:
            t = loop.spawn(cluster.kv_read(leader.name, "x"))
            out = await P.sim.wait_for(t, 5 * P.SECOND)
            assert out["kv"]["value"] == 2, "stale linearizable read!"
            seen = out
        except (SimError, TimeoutError) as e:
            seen = repr(e)
        return seen, loop.now

    return loop.run_coro(main())


def test_resumed_stale_leader_cannot_serve_stale_read():
    on_cluster(_resumed_stale_leader)


def _election_seed_sweep(P):
    seen = []
    for seed in range(12):
        loop = P.sim.SimLoop(seed=1000 + seed)
        P.sim.set_current_loop(loop)
        cluster = P.sut.Cluster(loop, NODES)
        cluster.launch()
        terms_with_leader = {}

        async def main():
            leader = await P.await_leader(cluster)
            await cluster.kv_txn(leader.name, P.put_txn("k", seed))
            for round_ in range(2):
                victim = [n for n in cluster.nodes.values()
                          if n.alive and n.role == "leader"]
                if victim:
                    cluster.kill_node(victim[0].name)
                leader = await P.await_leader(cluster, timeout_s=30)
                await cluster.kv_txn(leader.name,
                                     P.put_txn(f"k{round_}", round_))
            for n in NODES:
                if not cluster.nodes[n].alive:
                    cluster.start_node(n)
            leader = await P.await_leader(cluster, timeout_s=30)
            out = await cluster.kv_read(leader.name, "k")
            assert out["kv"]["value"] == seed
            for n in cluster.nodes.values():
                if n.alive and n.role == "leader":
                    other = terms_with_leader.get(n.term)
                    assert other in (None, n.name), \
                        f"two leaders in term {n.term}: {other}, {n.name}"
                    terms_with_leader[n.term] = n.name
            return leader.name, loop.now

        seen.append((loop.run_coro(main()), terms_with_leader))
        cluster.shutdown()
        P.sim.set_current_loop(None)
    return seen


def test_election_seed_sweep():
    """Elections converge across seeds with leader kills, at most one
    leader a term, committed writes survive; every seed's leaders and
    times are the reference's."""
    on_pkg(_election_seed_sweep)


def _split_vote_possible(P):
    saw = []
    for seed in range(20):
        loop = P.sim.SimLoop(seed=seed)
        P.sim.set_current_loop(loop)
        cluster = P.sut.Cluster(loop, NODES)
        cluster.launch()

        async def main():
            for n in cluster.nodes.values():
                n.election_deadline = loop.now + 1
            await P.sim.sleep(60 * P.MS)
            candidates = [n.name for n in cluster.nodes.values()
                          if n.role == "candidate"]
            await P.await_leader(cluster, timeout_s=30)
            return candidates, loop.now

        saw.append(loop.run_coro(main()))
        cluster.shutdown()
        P.sim.set_current_loop(None)
    assert any(len(c) >= 2 for c, _ in saw), \
        "no seed produced competing campaigns — elections look atomic"
    return saw


def test_split_vote_possible():
    on_pkg(_split_vote_possible)


def _fsync_mode_survives(P, loop, cluster):
    async def main():
        await P.await_leader(cluster)
        for i in range(30):
            await cluster.kv_txn("n1", P.put_txn(f"k{i}", i))
        await P.sim.sleep(500 * P.MS)
        for n in list(cluster.nodes):
            cluster.kill_node(n, lose_unfsynced=True)
        for n in list(cluster.nodes):
            cluster.start_node(n)
        await P.await_leader(cluster, timeout_s=30)
        outs = []
        for i in range(30):
            out = await cluster.kv_read("n1", f"k{i}")
            assert out["kv"] is not None and out["kv"]["value"] == i, i
            outs.append(out)
        return outs, loop.now

    return loop.run_coro(main())


def test_fsync_mode_survives_lose_unfsynced():
    on_cluster(_fsync_mode_survives, seed=4, nodes=["n1", "n2", "n3"],
               cfg={"unsafe_no_fsync": False})


# ---- RecordFile (lazy byte materialization, wal.py) -----------------------

def _obj_mode_roundtrip(P):
    f = P.wal.RecordFile()
    f.append(("a", 1), sync=True)
    f.append(("b", [1, 2, 3]), sync=True)
    f.append(("c", 3), sync=False)
    assert not f.byte_mode
    items, err = f.read()
    assert err is None and [i[0] for i in items] == ["a", "b", "c"]
    f.lose_unfsynced()
    items2, err = f.read()
    assert err is None and [i[0] for i in items2] == ["a", "b"]
    assert f.size > 0
    return items, items2, f.size


def test_record_file_obj_mode_roundtrip():
    on_pkg(_obj_mode_roundtrip)


def _corruption_breaks_crc(P):
    f = P.wal.RecordFile()
    for i in range(8):
        f.append((i, i * 10), sync=True)
    f.corrupt(random.Random(5), mode="bitflip", probability=0.01)
    assert f.byte_mode
    damaged = bytes(f._bytes)
    items, err = f.read()
    assert err in ("crc-mismatch", "torn-record")
    assert len(items) < 8
    f.set_records(items, sync=True)
    assert not f.byte_mode
    assert f.read() == (items, None)
    return damaged, items, err


def test_record_file_corruption_materializes_and_breaks_crc():
    on_pkg(_corruption_breaks_crc)


def _truncate(P):
    f = P.wal.RecordFile()
    for i in range(6):
        f.append((i, "x" * 50), sync=True)
    f.corrupt(random.Random(3), mode="truncate", truncate_bytes=80)
    items, err = f.read()
    assert err == "torn-record"
    assert 0 < len(items) < 6
    return bytes(f._bytes), items


def test_record_file_truncate_drops_tail_records():
    on_pkg(_truncate)


def _bytes_mode_append(P):
    f = P.wal.RecordFile()
    f.append((1, "a"), sync=True)
    f.corrupt(random.Random(7), mode="bitflip", probability=0.0)
    assert f.byte_mode
    f.append((2, "b"), sync=False)
    items, err = f.read()
    assert err is None and len(items) == 2
    current = bytes(f._bytes)
    f.lose_unfsynced()
    items2, err = f.read()
    assert err is None and len(items2) == 1
    return current, items, items2


def test_record_file_bytes_mode_append_and_lose():
    on_pkg(_bytes_mode_append)


def _clone_events_cow(P):
    Txn = P.sut.Txn
    s = P.store.Store()
    s.apply_txn(Txn((), (("put", "k", 1, 0),), ()))
    snap = s.clone()
    assert snap.events is s.events
    s.apply_txn(Txn((), (("put", "k", 2, 0),), ()))
    assert snap.events is not s.events
    assert len(snap.events) == 1 and len(s.events) == 2
    return s.events, snap.events


def test_store_clone_events_cow():
    on_pkg(_clone_events_cow)


def _unsynced_rewrite(P):
    f = P.wal.RecordFile()
    for i in range(8):
        f.append((i, "v" * 40), sync=True)
    f.corrupt(random.Random(2), mode="bitflip", probability=0.02)
    _, err0 = f.read()
    assert err0 is not None
    f.set_records([(0, "clean")], sync=False)
    assert f.read() == ([(0, "clean")], None)
    f.lose_unfsynced()
    _, err1 = f.read()
    assert err1 == err0
    return bytes(f._bytes), err0


def test_record_file_unsynced_rewrite_preserves_damaged_durable():
    on_pkg(_unsynced_rewrite)


def _new_leader_read_index(P, loop, cluster):
    async def main():
        leader = await P.await_leader(cluster)
        await cluster.kv_txn("n1", P.put_txn("k", 1))
        await P.sim.sleep(1 * P.SECOND)
        g = next(n for n in cluster.nodes.values()
                 if n.alive and n.name != leader.name)
        e = P.cl.LogEntry(index=g.last_index() + 1, term=leader.term,
                          kind="txn", payload=P.put_txn("k", 2))
        g.log.append(e)
        g.wal_append(e)
        cluster.kill_node(leader.name)
        g.role = "leader"
        g.term = leader.term + 1
        g.leader_hint = g.name
        read_state = {}

        async def read():
            read_state["out"] = await cluster.kv_read(g.name, "k")

        task = loop.spawn(read())
        await P.sim.sleep(int(0.5 * P.SECOND))
        if task.done:
            assert read_state["out"]["kv"]["value"] == 2, (
                f"stale linearizable read: {read_state['out']['kv']}")
        else:
            task.cancel()
        return g.name, task.done, read_state, loop.now

    return loop.run_coro(main())


def test_new_leader_read_index_waits_for_own_term_commit():
    """A newly elected leader serves no linearizable read until its
    own-term noop commits (manufactured lagging-leader state, as the
    reference's test builds it)."""
    on_cluster(_new_leader_read_index)


# ---- the simulated files' bytes ---------------------------------------------

def _cluster_file_bytes(P):
    """Snapshots and WAL of a cluster past several snapshots (over 64 KB
    a snapshot, so the pickle stream has more than one frame), then a
    seeded bitflip of each file and what replay keeps."""
    loop = P.sim.SimLoop(seed=3)
    P.sim.set_current_loop(loop)
    try:
        cluster = P.sut.Cluster(loop, ["n1", "n2", "n3"],
                                P.sut.ClusterConfig(snapshot_count=50))
        cluster.launch()

        async def go():
            await P.await_leader(cluster)
            for i in range(300):
                await cluster.kv_txn("n1", P.put_txn(
                    f"k{i % 97}", [i, f"{i:04d}" * 250, {"x": (i, 1.5)}]))
        loop.run_coro(go())
        node = cluster.nodes["n1"]
        out = []
        for f in (node.snap, node.wal):
            items, err = f.read()
            assert err is None and items
            raw = P.wal.encode_records(items)
            back, err = P.wal.decode_records(raw)
            assert err is None and len(back) == len(items)
            # read back as this package's own classes
            assert all(type(x).__module__.startswith(P.sut.__name__)
                       for rec in back for x in rec
                       if type(x).__module__.partition(".")[0]
                       .startswith("jepsen"))
            f.corrupt(random.Random(9), mode="bitflip", probability=1e-4)
            kept, err = f.read()
            out.append((raw, bytes(f._bytes), len(kept), err))
        cluster.shutdown()
        return out
    finally:
        P.sim.set_current_loop(None)


def test_record_bytes_equal_the_references():
    """The port pickles its records under the reference's module paths
    and reads them back as its own classes: the files' bytes, the
    damage a seeded bitflip does and what replay keeps are the
    reference's."""
    out = both(lambda pkg: _cluster_file_bytes(Pkg(pkg)))
    assert len(out[0][0]) > 65_536
    assert b"jepsen_etcd_tpu.sut.store" in out[0][0]
    assert b"jepsen_etcd_tpu_torch" not in out[0][0] + out[1][0]
