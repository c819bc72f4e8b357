"""Register workload: linearizable read/write/CAS on independent keys.

Re-design of ``register.clj``: ops carry ``[version, value]`` pairs; the
client derives the resulting version from etcd's prev-kv (write: prev
version + 1, register.clj:30-34; cas: prev version + 1 from the put's
prev-kv, register.clj:36-44), feeding the VersionedRegister model.

Checked per-key (independent keys, ``2 * node-count`` concurrent keys,
with a reserved read pool of node-count threads, register.clj:102-119).
"""

from __future__ import annotations

from ..core.op import Op
from ..client import with_errors
from ..generators import independent, mix, reserve, limit
from ..models import VersionedRegister
from ..checkers import compose, independent_checker
from ..checkers.session import SessionGuarantees
from ..checkers.tpu_linearizable import CPU_CUTOFF, TPULinearizableChecker
from .base import WorkloadClient


class RegisterClient(WorkloadClient):
    async def invoke(self, test: dict, op: Op) -> Op:
        k, (version, value) = op.value
        key = f"r{k}"

        async def go():
            if op.f == "read":
                kv = await self.conn.get(
                    key, serializable=test.get("serializable", False))
                v = [kv["version"], kv["value"]] if kv else [0, None]
                return op.evolve(type="ok", value=(k, v))
            if op.f == "write":
                r = await self.conn.put(key, value)
                prev = r.get("prev-kv")
                ver = (prev["version"] if prev else 0) + 1
                return op.evolve(type="ok", value=(k, [ver, value]))
            if op.f == "cas":
                old, new = value
                r = await self.conn.cas(key, old, new)
                if r["succeeded"]:
                    prev = r["puts"][0].get("prev-kv")
                    ver = (prev["version"] if prev else 0) + 1
                    return op.evolve(type="ok", value=(k, [ver, value]))
                return op.evolve(type="fail", error="did-not-succeed")
            raise ValueError(f"unknown f {op.f}")

        return await with_errors(op, {"read"}, go)


def r(test, ctx):
    return {"f": "read", "value": [None, None]}


def w(test, ctx):
    return {"f": "write", "value": [None, ctx.rng.randint(0, 4)]}


def cas(test, ctx):
    return {"f": "cas",
            "value": [None, [ctx.rng.randint(0, 4), ctx.rng.randint(0, 4)]]}


def workload(opts: dict) -> dict:
    """Groups of 2n threads work keys one at a time; within a group, n
    threads are a reserved read pool and the rest mix writes and CASes
    (register.clj:113-119: concurrent-generator (* 2 n) keys, reserve n r,
    limit ops-per-key)."""
    n = len(opts["nodes"])
    conc = opts.get("concurrency", 2 * n)
    group = max(1, min(2 * n, conc))
    readers = max(1, group // 2)
    # soak windows rotate key_offset so a retained live cluster never
    # re-serves a key an earlier window already wrote and checked
    k0 = int(opts.get("key_offset") or 0)
    return {
        "client": RegisterClient(),
        "checker": independent_checker(compose({
            # the wave kernel with sound CPU-oracle fallback
            # (the positioned timeline renders at the top of the stack,
            # compose.py — a per-key subhistory would lose the nemesis
            # bands and clobber timeline.html once per key)
            # force_kernel pins the kernel path (no native-DFS size
            # cutoff): tiny sim histories become device-bound
            "linear": TPULinearizableChecker(
                lambda: VersionedRegister(0, None),
                cpu_cutoff=None if opts.get("force_kernel")
                else CPU_CUTOFF,
                device=opts.get("device")),
            # session guarantees (monotone reads, writes-follow-reads)
            # over the version payloads: strictly weaker than "linear"
            # but localizes WHICH session saw an anomaly, and cheap
            # enough (one vectorized pass) to run on every history
            "session": SessionGuarantees(),
        })),
        "generator": independent.concurrent_generator(
            group,
            range(k0, 10 ** 12),
            lambda k: limit(opts.get("ops_per_key", 200),
                            reserve(readers, r, mix([w, cas])))),
    }
