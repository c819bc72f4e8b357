"""Lock workloads: demonstrations that etcd locks are unsafe.

Re-design of ``lock.clj``. etcd lock acquisition grants a short lease
(TTL 2 s, lock.clj:18-20), keeps it alive from a background task, and
acquires the named lock under that lease (lock.clj:22-56). Because the
lease is timed at the *leader* and reset on leader change, two clients
can genuinely hold the "lock" at once under faults — so ``lock`` and
``lock-set`` are expected to FAIL under nemeses. ``lock-etcd-set`` is
the exception: its txn-level ``version(lock_key) > 0`` guard holds up,
and the reference expects it to pass (WORKLOADS_EXPECTED_TO_PASS
removes only :lock and :lock-set, etcd.clj:51-53).

Three clients:

- LinearizableLockClient (lock.clj:91-134): bare acquire/release ops
  checked against a Knossos-style mutex model;
- LockingSetClient (lock.clj:139-179): an *in-memory* list guarded by
  the etcd lock; the critical section sleeps ~latency, so an expired
  lease lets two holders interleave read-modify-write and lose adds;
- LockingEtcdSetClient (lock.clj:185-228): the list lives in etcd and
  updates are guarded by ``version(lock_key) > 0`` inside the txn
  (lock.clj:214-216) — stronger, but still unsafe: the lock key can
  outlive the holder's critical section entry.

Failed lock *releases* with known errors coerce to :ok — the critical
section is over either way — except :not-held, which must stay a
failure or we'd double-release (lock.clj:66-86).

The port of the reference's ``workloads/lock.py``. ``lock``'s checker
runs where ``opts["device"]`` names (the card unless ``"cpu"``), and
``opts["force_kernel"]`` pins it to the wave kernel as it does for
``register``; the reference's ``lock`` ignores ``force_kernel`` and
routes by size alone.
"""

from __future__ import annotations

from ..core.op import Op
from ..client import with_errors
from ..client import txn as t
from ..checkers import compose
from ..checkers.tpu_linearizable import CPU_CUTOFF, TPULinearizableChecker
from ..checkers.set_full import SetFull
from ..generators import mix
from ..models import Mutex
from ..runner.sim import current_loop, sleep, SECOND
from ..sut.errors import SimError
from .base import WorkloadClient

LEASE_TTL = 2 * SECOND  # lock.clj:18-20
MS = 1_000_000


async def acquire(conn, lock_name: str, process) -> dict:
    """Grant lease -> spawn keepalive -> acquire lock (lock.clj:22-56).
    On failure, close the keepalive AND revoke the lease: a timed-out
    lock request may still be outstanding server-side and would otherwise
    hold the lock until the lease naturally expires."""
    lease_id = await conn.lease_grant(LEASE_TTL)
    listener = conn.spawn_keepalive(lease_id, LEASE_TTL // 3)
    try:
        lock_key = await conn.acquire_lock(lock_name, lease_id)
        return {"lease-id": lease_id, "listener": listener,
                "lock-key": lock_key, "process": process}
    except BaseException:
        listener.cancel()
        try:
            await conn.lease_revoke(lease_id)
        except (SimError, TimeoutError):
            pass
        raise


async def release(conn, lease_lock: dict) -> None:
    """Stop the keepalive, release the lock, revoke the lease
    (lock.clj:58-64)."""
    lease_lock["listener"].cancel()
    await conn.release_lock(lease_lock["lock-key"])
    await conn.lease_revoke(lease_lock["lease-id"])


def _is_not_held(err) -> bool:
    return (err == "not-held" or
            (isinstance(err, (list, tuple)) and err
             and err[0] == "not-held"))


async def lock_with_errors(op: Op, thunk) -> Op:
    """The lock-specific with-errors (lock.clj:66-86): failed releases
    with known errors still mean the critical section is over -> :ok,
    except :not-held (a double release must stay a failure)."""
    res = await with_errors(op, {"acquire", "release"}, thunk)
    if (op.f == "release" and res["type"] == "fail"
            and not _is_not_held(res.get("error"))):
        return res.evolve(type="ok")
    return res


class LinearizableLockClient(WorkloadClient):
    LOCK = "foo"

    def open(self, test: dict, node: str) -> "LinearizableLockClient":
        new = super().open(test, node)
        new.lease_lock = None  # per-process holding state
        return new

    async def invoke(self, test: dict, op: Op) -> Op:
        async def go():
            if op.f == "acquire":
                if self.lease_lock:
                    return op.evolve(type="fail", error="already-held")
                self.lease_lock = await acquire(self.conn, self.LOCK,
                                                op["process"])
                return op.evolve(type="ok")
            if op.f == "release":
                if not self.lease_lock:
                    return op.evolve(type="fail", error="not-held")
                try:
                    await release(self.conn, self.lease_lock)
                    return op.evolve(type="ok")
                finally:
                    # even if release failed, we stopped renewing; we
                    # will not try again (lock.clj:117-122)
                    self.lease_lock = None
            raise ValueError(f"unknown f {op.f}")

        return await lock_with_errors(op, go)


class LockingSetClient(WorkloadClient):
    """In-memory list guarded by an etcd lock (lock.clj:139-179)."""

    LOCK = "foo"

    def __init__(self, latency_ms: int = 1000):
        super().__init__()
        self.latency_ms = latency_ms
        self.shared = []        # the in-memory set, shared by all opens

    async def invoke(self, test: dict, op: Op) -> Op:
        loop = current_loop()
        added = [False]

        async def go():
            if op.f == "read":
                return op.evolve(type="ok", value=list(self.shared))
            if op.f == "add":
                lease_lock = await acquire(self.conn, self.LOCK,
                                           op["process"])
                v = list(self.shared)
                await sleep(loop.rng.randint(0, 2 * self.latency_ms) * MS)
                self.shared[:] = v + [op.value]
                added[0] = True
                await release(self.conn, lease_lock)
                return op.evolve(type="ok")
            raise ValueError(f"unknown f {op.f}")

        res = await with_errors(op, {"read"}, go)
        if op.f == "add":
            # the add's *effect* is purely the in-memory write: whatever
            # the locking path did, ok iff the write happened
            # (lock.clj:167-177)
            return res.evolve(type="ok" if added[0] else "fail")
        return res


class LockingEtcdSetClient(WorkloadClient):
    """etcd-resident list guarded by lock + txn (lock.clj:185-228)."""

    LOCK = "foo"
    KEY = "a-set"

    def __init__(self, latency_ms: int = 1000):
        super().__init__()
        self.latency_ms = latency_ms

    async def invoke(self, test: dict, op: Op) -> Op:
        loop = current_loop()

        if op.f == "read":
            async def read():
                kv = await self.conn.get(
                    self.KEY, serializable=test.get("serializable", False))
                return op.evolve(type="ok",
                                 value=list(kv["value"]) if kv else None)
            return await with_errors(op, {"read"}, read)

        if op.f == "add":
            async def add():
                lease_lock = await acquire(self.conn, self.LOCK,
                                           op["process"])
                try:
                    async def mutate():
                        kv = await self.conn.get(self.KEY)
                        v = list(kv["value"]) if kv else []
                        await sleep(loop.rng.randint(
                            0, 2 * self.latency_ms) * MS)
                        # guard: the lock key still exists
                        # (lock.clj:214-216 — still unsafe!)
                        r = await self.conn.txn(
                            [t.gt(lease_lock["lock-key"], t.version(0))],
                            [t.put(self.KEY, v + [op.value])])
                        return op.evolve(
                            type="ok" if r["succeeded"] else "fail")
                    return await with_errors(op, set(), mutate)
                finally:
                    try:
                        await release(self.conn, lease_lock)
                    except (SimError, TimeoutError):
                        pass
            return await with_errors(op, {"add"}, add)

        raise ValueError(f"unknown f {op.f}")


def workload(opts: dict) -> dict:
    """Linearizable acquire/release on one lock (lock.clj:238-246)."""
    def acquires(test, ctx):
        return {"f": "acquire", "value": None}

    def releases(test, ctx):
        return {"f": "release", "value": None}

    return {
        "client": LinearizableLockClient(),
        "checker": compose({
            # mutex packs onto the wave kernel via the CAS-register
            # adapter (ops/wgl.py mutex_adapter); CPU oracle on fallback
            # (the positioned timeline renders at the top of the stack,
            # compose.py — full history, nemesis bands)
            "linear": TPULinearizableChecker(
                Mutex,
                cpu_cutoff=None if opts.get("force_kernel")
                else CPU_CUTOFF,
                device=opts.get("device")),
        }),
        "generator": mix([acquires, releases]),
    }


def _set_like_workload(client) -> dict:
    counter = iter(range(10 ** 12))

    def adds(test, ctx):
        return {"f": "add", "value": next(counter)}

    def reads(test, ctx):
        return {"f": "read", "value": None}

    return {
        "client": client,
        "checker": compose({
            "set": SetFull(linearizable=True),
        }),
        "generator": mix([adds, reads]),
    }


class LeaseChurnClient(WorkloadClient):
    """Lease-churn locking: short TTLs and NO keepalive, so leases
    expire constantly and the lock server re-grants after every
    expiry. Checked by checkers/mvcc.py LeaseChurn: no two sessions'
    *certain-hold* windows (clipped at acquire-invoke + TTL) may
    overlap — expired-lease re-grants are excused by the clip, so
    this workload is expected to PASS even under pause faults, unlike
    ``lock``/``lock-set``."""

    LOCK = "churn"

    def open(self, test: dict, node: str) -> "LeaseChurnClient":
        new = super().open(test, node)
        new.lease_lock = None
        return new

    async def invoke(self, test: dict, op: Op) -> Op:
        from ..checkers.mvcc import DEFAULT_LEASE_TTL_MS
        ttl_ns = int(test.get("lease_ttl_ms")
                     or DEFAULT_LEASE_TTL_MS) * MS

        async def go():
            if op.f == "acquire":
                if self.lease_lock:
                    return op.evolve(type="fail", error="already-held")
                lease_id = await self.conn.lease_grant(ttl_ns)
                try:
                    lock_key = await self.conn.acquire_lock(
                        self.LOCK, lease_id)
                except BaseException:
                    try:
                        await self.conn.lease_revoke(lease_id)
                    except (SimError, TimeoutError):
                        pass
                    raise
                self.lease_lock = {"lease-id": lease_id,
                                   "lock-key": lock_key}
                return op.evolve(type="ok")
            if op.f == "release":
                if not self.lease_lock:
                    return op.evolve(type="fail", error="not-held")
                ll, self.lease_lock = self.lease_lock, None
                await self.conn.release_lock(ll["lock-key"])
                await self.conn.lease_revoke(ll["lease-id"])
                return op.evolve(type="ok")
            raise ValueError(f"unknown f {op.f}")

        return await lock_with_errors(op, go)


def lease_workload(opts: dict) -> dict:
    """Acquire/release churn under short, never-renewed leases
    (checkers/mvcc.py LeaseChurn: overlapping certain-hold windows)."""
    from ..checkers.mvcc import LeaseChurn

    def acquires(test, ctx):
        return {"f": "acquire", "value": None}

    def releases(test, ctx):
        return {"f": "release", "value": None}

    return {
        "client": LeaseChurnClient(),
        "checker": compose({"lease": LeaseChurn()}),
        "generator": mix([acquires, releases]),
    }


def set_workload(opts: dict) -> dict:
    """In-memory set under an etcd lock (lock.clj:248-259)."""
    return _set_like_workload(LockingSetClient())


def etcd_set_workload(opts: dict) -> dict:
    """etcd-resident set under an etcd lock (lock.clj:261-268)."""
    return _set_like_workload(LockingEtcdSetClient())
