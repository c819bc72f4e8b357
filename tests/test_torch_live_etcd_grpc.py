"""The port's native-gRPC real-etcd adapter, driven hermetically (the
shapes of the reference's tests/test_etcd_grpc.py).

client/etcd_grpc.py speaks etcdserverpb/v3lockpb over a real grpc
channel; sut/grpc_gateway.py serves those frames from the simulated
MVCC store. Round-tripping the adapter against the gateway exercises
the exact frames a live etcd would see (proto field numbers, compare
targets, txn branches, bidi watch + keepalive streams, compaction
cancel framing) — the reference's actual wire protocol (jetcd,
client.clj:14-68) without needing an etcd binary. Mirrors
test_torch_live_etcd_http.py so both live adapters carry the same
guarantees.
"""

import pytest

grpc = pytest.importorskip("grpc")

from jepsen_etcd_tpu_torch.runner.wall import WallLoop
from jepsen_etcd_tpu_torch.runner.sim import set_current_loop, SECOND
from jepsen_etcd_tpu_torch.client.etcd_grpc import GrpcEtcdClient
from jepsen_etcd_tpu_torch.client import txn as t
from jepsen_etcd_tpu_torch.sut.grpc_gateway import serve_grpc
from jepsen_etcd_tpu_torch.sut.errors import SimError


@pytest.fixture()
def gateway():
    srv, state, port = serve_grpc()
    endpoint = f"http://127.0.0.1:{port}"
    yield endpoint, state
    srv.stop(0)


def run(coro):
    loop = WallLoop()
    set_current_loop(loop)
    try:
        return loop.run_coro(coro)
    finally:
        set_current_loop(None)
        loop.shutdown()


def test_kv_roundtrip(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        assert await c.get("k") is None
        r = await c.put("k", {"a": [1, 2]})
        assert r["prev-kv"] is None
        kv = await c.get("k")
        assert kv["value"] == {"a": [1, 2]}
        assert kv["version"] == 1
        r = await c.put("k", "v2")
        assert r["prev-kv"]["value"] == {"a": [1, 2]}
        kv = await c.get("k")
        assert kv["version"] == 2
        assert await c.revision() >= kv["mod-revision"]
        return True

    assert run(main())


def test_cas_and_txn_guards(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        await c.put("reg", 1)
        ok = await c.cas("reg", 1, 2)
        assert ok["succeeded"]
        bad = await c.cas("reg", 1, 3)
        assert not bad["succeeded"]
        kv = await c.get("reg")
        assert kv["value"] == 2 and kv["version"] == 2
        # version + mod-revision guards (the append workload's shapes)
        res = await c.txn([t.eq("reg", t.version(2))],
                          [t.get("reg"), t.put("reg", 5)],
                          [t.get("reg")])
        assert res["succeeded"]
        assert res["gets"][0]["value"] == 2
        res = await c.txn(
            [t.lt("reg", t.mod_revision(1))],
            [t.put("reg", 9)], [t.get("reg")])
        assert not res["succeeded"]
        assert res["gets"][0]["value"] == 5
        return True

    assert run(main())


def test_swap_retry_loop(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        for i in range(5):
            got = await c.swap("s", lambda v: (v or 0) + 1)
            assert got == i + 1
        return True

    assert run(main())


def test_lease_lock_cycle(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        lease = await c.lease_grant(2 * SECOND)
        assert await c.lease_keepalive_once(lease) > 0
        key = await c.acquire_lock("lk", lease)
        assert key.startswith("lk/")
        await c.release_lock(key)
        await c.lease_revoke(lease)
        with pytest.raises(SimError) as ei:
            await c.lease_keepalive_once(lease)
        assert ei.value.type == "lease-not-found"
        return True

    assert run(main())


def test_lease_revoke_deletes_attached_keys(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        lease = await c.lease_grant(2 * SECOND)
        key = await c.acquire_lock("held", lease)
        assert await c.get(key) is not None
        await c.lease_revoke(lease)
        assert await c.get(key) is None  # lock key went with the lease
        return True

    assert run(main())


def test_lease_grant_rounds_ttl_up(gateway):
    """A 2.9s lease must become TTL=3, not 2 (same contract as the
    HTTP adapter: truncation would expire leases earlier than the
    harness's lease math assumes)."""
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        lease = await c.lease_grant(int(2.9 * SECOND))
        return await c.lease_keepalive_once(lease)

    assert run(main()) == 3 * SECOND


def test_watch_stream(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        from jepsen_etcd_tpu_torch.runner.sim import current_loop, sleep
        loop = current_loop()
        seen = []
        done = loop.future()

        def on_events(evs):
            seen.extend(evs)
            if len(seen) >= 3:
                done.set_result(True)

        def on_error(e):
            if not done.done:
                done.set_exception(e)

        w = c.watch("w", 1, on_events, on_error)
        await sleep(int(0.1 * SECOND))
        for i in range(3):
            await c.put("w", i)
        await done
        w.cancel()
        assert [e.kv["value"] for e in seen[:3]] == [0, 1, 2]
        revs = [e.revision for e in seen]
        assert revs == sorted(revs)
        return True

    assert run(main())


def test_watch_compaction_cancel_carries_compact_revision(gateway):
    """A watch below the compact horizon must come back as a compacted
    cancel CARRYING the server's compact_revision (real etcd's
    canceled WatchResponse framing) — same contract as the HTTP
    adapter."""
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        from jepsen_etcd_tpu_torch.runner.sim import current_loop
        loop = current_loop()
        for i in range(6):
            await c.put("ck", i)
        await c.compact(5)
        done = loop.future()

        def on_events(evs):
            pass

        def on_error(e):
            if not done.done:
                done.set_result(e)

        w = c.watch("ck", 1, on_events, on_error)  # below the horizon
        err = await done
        w.cancel()
        assert isinstance(err, SimError) and err.type == "compacted", err
        assert getattr(err, "compact_revision", None) == 5, vars(err)
        return True

    assert run(main())


def test_status_members_maintenance(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        st = await c.status()
        assert st["leader"] and "sim-gateway" in st["version"]
        ms = await c.member_list()
        assert len(ms) == 1 and ms[0]["id"] == 1
        assert await c.member_id_of_node("gw0") == 1
        await c.put("x", 1)
        await c.put("x", 2)
        await c.compact(await c.revision())
        await c.defrag()
        assert await c.await_node_ready()
        return True

    assert run(main())


def test_error_classification(gateway):
    endpoint, _ = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        await c.put("e", 1)
        await c.compact(await c.revision())
        with pytest.raises(SimError) as ei:
            await c.compact(1)   # below the compact horizon
        assert ei.value.type == "compacted" and ei.value.definite
        return True

    assert run(main())


def test_connect_failure_is_indefinite():
    async def main():
        c = GrpcEtcdClient("http://127.0.0.1:1")  # nothing listens
        with pytest.raises(SimError) as ei:
            await c.get("k")
        assert ei.value.type == "unavailable"
        assert not ei.value.definite
        return True

    assert run(main())


def test_register_workload_ops_against_gateway(gateway):
    """The register client's exact op shapes (read / write-with-prev-kv
    / value-cas) round-trip the gRPC wire and produce a linearizable
    history per the checker."""
    endpoint, _ = gateway
    from jepsen_etcd_tpu_torch.core.op import Op
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.checkers import check_history
    from jepsen_etcd_tpu_torch.models import VersionedRegister

    async def main():
        c = GrpcEtcdClient(endpoint)
        ops = []

        def rec(i, f, v):
            ops.append(Op(type="invoke", process=0, f=f,
                          value=[None, None if f == "read" else v]))
            ops.append(Op(type="ok", process=0, f=f, value=i))

        r = await c.put("r0", 3)
        prev = r.get("prev-kv")
        rec([(prev["version"] if prev else 0) + 1, 3], "write", 3)
        kv = await c.get("r0")
        rec([kv["version"], kv["value"]], "read", None)
        res = await c.cas("r0", 3, 4)
        assert res["succeeded"]
        ver = res["puts"][0]["prev-kv"]["version"] + 1
        rec([ver, [3, 4]], "cas", [3, 4])
        kv = await c.get("r0")
        rec([kv["version"], kv["value"]], "read", None)
        return History(ops)

    h = run(main())
    out = check_history(VersionedRegister(), h)
    assert out["valid?"] is True, out


def test_wire_interop_with_http_gateway_semantics(gateway):
    """The gRPC and HTTP adapters must produce identical kv dicts for
    identical operations — histories (and therefore checker verdicts)
    are client-type independent."""
    endpoint, state = gateway

    async def main():
        c = GrpcEtcdClient(endpoint)
        await c.put("same", {"x": 1})
        return await c.get("same")

    kv = run(main())
    assert kv["value"] == {"x": 1}
    assert set(kv) == {"key", "value", "version", "create-revision",
                       "mod-revision", "lease"}
    # the store itself saw the json-codec bytes (jepsen.codec contract)
    with state.lock:
        raw = state.store.range_interval("same", None)[0]
    assert raw["value"] == {"x": 1}
