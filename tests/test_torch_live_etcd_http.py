"""The port's real-etcd HTTP adapter, driven hermetically (the shapes
of the reference's tests/test_etcd_http.py).

client/etcd_http.py speaks the etcd v3 gRPC-JSON gateway wire format;
sut/http_gateway.py serves that format from the simulated MVCC store.
Round-tripping the adapter against the gateway exercises the exact
bytes a live etcd would see (base64 keys/values, compare targets, txn
branches, chunked watch streams) without needing an etcd binary. The WallLoop (runner/wall.py) supplies real-time
scheduling under the same API the virtual-time harness uses.
"""

import threading

import pytest

from jepsen_etcd_tpu_torch.runner.wall import WallLoop
from jepsen_etcd_tpu_torch.runner.sim import set_current_loop, SECOND
from jepsen_etcd_tpu_torch.client.etcd_http import HttpEtcdClient
from jepsen_etcd_tpu_torch.client import txn as t
from jepsen_etcd_tpu_torch.sut.http_gateway import serve
from jepsen_etcd_tpu_torch.sut.errors import SimError


@pytest.fixture()
def gateway():
    srv, state = serve()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    endpoint = f"http://127.0.0.1:{srv.server_address[1]}"
    yield endpoint, state
    srv.shutdown()
    srv.server_close()


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
        c = HttpEtcdClient(endpoint)
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
        c = HttpEtcdClient(endpoint)
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
        c = HttpEtcdClient(endpoint)
        for i in range(5):
            got = await c.swap("s", lambda v: (v or 0) + 1)
            assert got == i + 1
        return True

    assert run(main())


def test_lease_lock_cycle(gateway):
    endpoint, _ = gateway

    async def main():
        c = HttpEtcdClient(endpoint)
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
        c = HttpEtcdClient(endpoint)
        lease = await c.lease_grant(2 * SECOND)
        key = await c.acquire_lock("held", lease)
        assert await c.get(key) is not None
        await c.lease_revoke(lease)
        assert await c.get(key) is None  # lock key went with the lease
        return True

    assert run(main())


def test_watch_stream(gateway):
    endpoint, _ = gateway

    async def main():
        c = HttpEtcdClient(endpoint)
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


def test_status_members_maintenance(gateway):
    endpoint, _ = gateway

    async def main():
        c = HttpEtcdClient(endpoint)
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
        c = HttpEtcdClient(endpoint)
        await c.put("e", 1)
        await c.compact(await c.revision())
        with pytest.raises(SimError) as ei:
            await c.compact(1)   # below the compact horizon
        assert ei.value.type == "compacted" and ei.value.definite
        return True

    assert run(main())


def test_connect_failure_is_indefinite():
    async def main():
        c = HttpEtcdClient("http://127.0.0.1:1")  # nothing listens
        with pytest.raises(SimError) as ei:
            await c.get("k")
        assert ei.value.type == "connect-failed"
        assert not ei.value.definite
        return True

    assert run(main())


def test_register_workload_ops_against_gateway(gateway):
    """The register client's exact op shapes (read / write-with-prev-kv
    / value-cas) round-trip the wire and produce a linearizable
    history per the checker."""
    endpoint, _ = gateway
    from jepsen_etcd_tpu_torch.core.op import Op
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.checkers import check_history
    from jepsen_etcd_tpu_torch.models import VersionedRegister

    async def main():
        c = HttpEtcdClient(endpoint)
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


# ---- range, lease and watch edge cases --------------------------------------

def test_gateway_range_end_and_limit(gateway):
    """/v3/kv/range honors range_end (half-open interval) and limit —
    etcdctl get --prefix semantics."""
    endpoint, _ = gateway
    import json as _json
    import urllib.request

    def post(path, body):
        req = urllib.request.Request(
            endpoint + path, data=_json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as r:
            return _json.loads(r.read().decode())

    async def main():
        c = HttpEtcdClient(endpoint)
        for i in range(5):
            await c.put(f"pfx/{i}", i)
        await c.put("zzz", 99)
        return True

    assert run(main())
    from jepsen_etcd_tpu_torch.client.etcd_http import _key64, _unkey
    # prefix scan: [pfx/, pfx0) — the etcd prefix convention
    res = post("/v3/kv/range", {"key": _key64("pfx/"),
                                "range_end": _key64("pfx0")})
    keys = [_unkey(kv["key"]) for kv in res["kvs"]]
    assert keys == [f"pfx/{i}" for i in range(5)]
    assert res["count"] == "5" and res["more"] is False
    # limit + more flag
    res = post("/v3/kv/range", {"key": _key64("pfx/"),
                                "range_end": _key64("pfx0"),
                                "limit": 2})
    assert len(res["kvs"]) == 2 and res["more"] is True
    assert res["count"] == "5"
    # from-key-onward: range_end = "\0"
    res = post("/v3/kv/range", {"key": _key64("pfx/3"),
                                "range_end": _key64("\x00")})
    keys = [_unkey(kv["key"]) for kv in res["kvs"]]
    assert keys == ["pfx/3", "pfx/4", "zzz"]
    # single-key shape unchanged
    res = post("/v3/kv/range", {"key": _key64("zzz")})
    assert len(res["kvs"]) == 1 and res["count"] == "1"


def test_lease_grant_rounds_ttl_up(gateway):
    """A 2.9s lease must become TTL=3, not 2 (truncation would have
    expired leases earlier than the harness's lease math assumes)."""
    endpoint, _ = gateway

    async def main():
        c = HttpEtcdClient(endpoint)
        lease = await c.lease_grant(int(2.9 * SECOND))
        return await c.lease_keepalive_once(lease)

    assert run(main()) == 3 * SECOND


def test_wall_loop_waits_for_in_flight_pool_work():
    """run() must not exit idle while a run_in_thread completion is
    still in flight (its callback would be dropped)."""
    import time as _time
    loop = WallLoop()
    got = []
    fut = loop.run_in_thread(lambda: (_time.sleep(0.3), 42)[1])
    fut.add_done_callback(lambda f: got.append(f.result()))
    loop.run()  # no timers: an early idle exit would drop the callback
    assert got == [42]
    loop.shutdown()


def test_watch_compaction_cancel_carries_compact_revision(gateway):
    """A watch below the compact horizon must come back as a compacted
    cancel CARRYING the server's compact_revision (real etcd's canceled
    WatchResponse framing) — the final-watch restart uses it to resume
    at the true horizon instead of guessing from max-observed
    revision."""
    endpoint, _ = gateway

    async def main():
        c = HttpEtcdClient(endpoint)
        from jepsen_etcd_tpu_torch.runner.sim import current_loop, sleep
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
