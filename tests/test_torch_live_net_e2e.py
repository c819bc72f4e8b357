"""Network-fault e2e through the port's userspace proxy plane (net/): the
shapes of the reference's tests/test_net_e2e.py.

A 3-node fake-etcd cluster with every peer/client URL fronted by the
plane (--net-proxy): a partitioned minority refuses writes with the
wire shape real etcd gives (503 / "etcdserver: no leader" -> an
indefinite SimError), the majority keeps progressing, and healing
restores the minority — plus the nemesis partition/latency packages
driving the SAME plane through their local-mode backend. The
real-binary variant runs behind @pytest.mark.live like every other
real-etcd path."""

import time

import pytest

from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.db.local import LocalDb
from jepsen_etcd_tpu_torch.nemesis.packages import nemesis_package
from jepsen_etcd_tpu_torch.runner.sim import set_current_loop
from jepsen_etcd_tpu_torch.runner.wall import WallLoop
from jepsen_etcd_tpu_torch.sut.errors import SimError

NODES = ["n1", "n2", "n3"]

#: how a quorum-less node may classify a write: the fake answers 503
#: "etcdserver: no leader" immediately; a real minority hangs into the
#: client deadline
UNAVAILABLE = {"unavailable", "no-leader", "timeout"}

#: peer-visibility probes run every 0.25 s with 1 s reply deadlines
#: (db/fake_etcd.py), so convergence comfortably fits this window
CONVERGE_S = 12.0


@pytest.fixture()
def wall_loop():
    loop = WallLoop()
    set_current_loop(loop)
    yield loop
    set_current_loop(None)
    loop.shutdown()


def build_proxied(tmp_path, binary="fake", nodes=NODES):
    db = LocalDb({"etcd_binary": binary,
                  "etcd_data_dir": str(tmp_path / "data"),
                  "client_type": "http",
                  "nodes": list(nodes),
                  "net_proxy": True,
                  "seed": 11})
    test = {"nodes": list(nodes), "client_type": "http",
            "db_mode": "local", "db": db}
    return db, test


@pytest.fixture()
def proxied_cluster(wall_loop, tmp_path):
    db, test = build_proxied(tmp_path)
    wall_loop.run_coro(db.setup(test))
    try:
        yield wall_loop, db, test
    finally:
        db.stop_all()
        assert db.leaked_pids() == []


def try_put(loop, db, test, node, key, value):
    """One write; returns None on success or the classified SimError."""
    async def story():
        c = db._client(test, node)
        try:
            await c.put(key, value)
            return None
        except SimError as e:
            return e
        finally:
            c.close()
    return loop.run_coro(story())


def await_write_fails(loop, db, test, node, timeout=CONVERGE_S):
    """Poll until a write to ``node`` raises (probe convergence is
    asynchronous); returns the SimError."""
    deadline = time.monotonic() + timeout
    err = None
    while time.monotonic() < deadline:
        err = try_put(loop, db, test, node, "poll-fail", 0)
        if err is not None:
            return err
        time.sleep(0.25)
    raise AssertionError(f"writes to {node} never started failing")


def await_write_ok(loop, db, test, node, timeout=CONVERGE_S):
    deadline = time.monotonic() + timeout
    err = None
    while time.monotonic() < deadline:
        err = try_put(loop, db, test, node, "poll-ok", 0)
        if err is None:
            return
        time.sleep(0.25)
    raise AssertionError(f"writes to {node} still failing: {err}")


def node_status(loop, db, test, node):
    async def story():
        c = db._client(test, node)
        try:
            return await c.status()
        finally:
            c.close()
    return loop.run_coro(story())


# ---- the acceptance story ---------------------------------------------------

def test_partition_minority_fails_majority_progresses_heals(
        proxied_cluster):
    loop, db, test = proxied_cluster
    plane = db.plane
    assert plane is not None
    # every node's client AND peer URL is fronted
    assert plane.stats()["links"] == 2 * len(NODES)
    for node in NODES:
        assert db.client_url(node) != db.listen_client_url(node)
    # healthy: every node takes writes and reports a leader
    for i, node in enumerate(NODES):
        assert try_put(loop, db, test, node, "k-setup", i) is None
        assert node_status(loop, db, test, node)["leader"]

    plane.partition([["n1", "n2"], ["n3"]])
    # the minority loses its roster majority once probes converge:
    # writes refuse with the real-etcd wire shape, INDEFINITE (the op
    # may not have happened -> :info in a run, never :fail-definite)
    err = await_write_fails(loop, db, test, "n3")
    assert err.type in UNAVAILABLE, err
    assert err.definite is not True
    assert node_status(loop, db, test, "n3")["leader"] is None
    # the majority side keeps progressing throughout
    assert try_put(loop, db, test, "n1", "k-maj", 1) is None
    assert try_put(loop, db, test, "n2", "k-maj", 2) is None

    plane.heal_partition()
    await_write_ok(loop, db, test, "n3")
    assert node_status(loop, db, test, "n3")["leader"]


def test_one_way_drop_degrades_visibility(proxied_cluster):
    """An asymmetric drop (n3's INBOUND from everyone severed on the
    probe round trip) still costs n3 its quorum: visibility needs the
    round trip, not just one leg."""
    loop, db, test = proxied_cluster
    db.plane.partition_pairs({("n1", "n3"), ("n2", "n3")})
    err = await_write_fails(loop, db, test, "n3")
    assert err.type in UNAVAILABLE, err
    # n1 still sees n2 (and vice versa): majority intact
    assert try_put(loop, db, test, "n1", "k-ow", 1) is None
    db.plane.heal_partition()
    await_write_ok(loop, db, test, "n3")


# ---- nemesis packages drive the plane backend -------------------------------

def test_nemesis_partition_package_drives_plane(proxied_cluster):
    loop, db, test = proxied_cluster
    plane = db.plane
    nem = nemesis_package({"nemesis": ["partition"], "nodes": NODES,
                           "nemesis_interval": 1})
    n = nem["nemesis"]
    assert {"start-partition", "stop-partition"} <= n.fs

    op = loop.run_coro(n.invoke(test, Op(type="invoke",
                                         f="start-partition",
                                         value="majority")))
    assert op.type == "info"
    assert plane.stats()["blocked"] == 2  # 3 nodes: 1x2 cross pairs
    loop.run_coro(n.invoke(test, Op(type="invoke", f="stop-partition",
                                    value=None)))
    assert plane.stats()["blocked"] == 0

    # one-way spec installs ORDERED tuples (asymmetric blackhole)
    op = loop.run_coro(n.invoke(test, Op(type="invoke",
                                         f="start-partition",
                                         value="one-way")))
    assert "blocked links" in str(op.value)
    assert plane.blocked and all(
        isinstance(p, tuple) and not isinstance(p, frozenset)
        for p in plane.blocked)
    srcs = {p[0] for p in plane.blocked}
    assert len(srcs) == 1 and len(plane.blocked) == len(NODES) - 1
    loop.run_coro(n.invoke(test, Op(type="invoke", f="stop-partition",
                                    value=None)))
    assert plane.stats()["blocked"] == 0


def test_nemesis_latency_package_slows_the_wire(proxied_cluster):
    loop, db, test = proxied_cluster
    nem = nemesis_package({"nemesis": ["latency"], "nodes": NODES,
                           "nemesis_interval": 1})
    n = nem["nemesis"]
    assert {"start-latency", "stop-latency"} <= n.fs
    loop.run_coro(n.invoke(test, Op(type="invoke", f="start-latency",
                                    value={"delta-ms": 150,
                                           "jitter-ms": 10})))
    assert db.plane.latency is not None
    t0 = time.monotonic()
    assert try_put(loop, db, test, "n1", "k-slow", 1) is None
    # request + response each pay >= delta on the client leg
    assert time.monotonic() - t0 >= 0.15
    op = loop.run_coro(n.invoke(test, Op(type="invoke",
                                         f="stop-latency", value=None)))
    assert op.value == "latency-cleared"
    assert db.plane.latency is None
    assert try_put(loop, db, test, "n1", "k-fast", 2) is None


# ---- the real binary, gated like every live path ----------------------------

@pytest.mark.live
def test_real_etcd_partition_through_proxy(etcd_binary, wall_loop,
                                           tmp_path):
    """Same story against real etcd: member-id attribution (sniffed
    X-Server-From -> names registered post-setup) lets the plane cut
    raft links; a minority leader loses quorum, the majority elects
    around it, heal restores."""
    db, test = build_proxied(tmp_path, binary=[etcd_binary])
    wall_loop.run_coro(db.setup(test))
    try:
        plane = db.plane
        # attribution installed from member_list() after setup
        assert set(plane.member_names.values()) == set(NODES)
        await_write_ok(wall_loop, db, test, "n1")
        plane.partition([["n1", "n2"], ["n3"]])
        err = await_write_fails(wall_loop, db, test, "n3", timeout=30)
        assert err.type in UNAVAILABLE, err
        # the majority side elects within its own half and progresses
        await_write_ok(wall_loop, db, test, "n1", timeout=30)
        plane.heal_partition()
        await_write_ok(wall_loop, db, test, "n3", timeout=30)
    finally:
        db.stop_all()
        assert db.leaked_pids() == []
