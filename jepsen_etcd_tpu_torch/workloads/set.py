"""Set workload: unique integers added to one key via retried CAS.

Re-design of ``set.clj``: a single key ``"a-set"`` holds the whole set;
``add`` ops append their element through the client's CAS-retry ``swap``
(set.clj:25-26 → client.clj:511-527), ``read`` ops fetch the full set
(serializable reads when the test says so, set.clj:21-23). Checked with
set-full in linearizable mode (set.clj:46); generator reserves 5 reader
threads, the rest add increasing ints (set.clj:47).
"""

from __future__ import annotations

import itertools

from ..core.op import Op
from ..client import with_errors
from ..generators import reserve
from ..checkers.set_full import SetFull
from .base import WorkloadClient

KEY = "a-set"


class SetClient(WorkloadClient):
    async def invoke(self, test: dict, op: Op) -> Op:
        async def go():
            if op.f == "read":
                kv = await self.conn.get(
                    KEY, serializable=test.get("serializable", False))
                return op.evolve(type="ok",
                                 value=list(kv["value"]) if kv else [])
            if op.f == "add":
                # conj on a set: append-if-absent, kept sorted for
                # deterministic read values
                def conj(s):
                    cur = list(s or [])
                    if op.value not in cur:
                        cur = sorted(cur + [op.value])
                    return cur
                await self.conn.swap(KEY, conj)
                return op.evolve(type="ok")
            raise ValueError(f"unknown f {op.f}")

        return await with_errors(op, {"read"}, go)

    async def setup(self, test: dict) -> None:
        await self.conn.put(KEY, [])


def workload(opts: dict) -> dict:
    counter = itertools.count()

    def r(test, ctx):
        return {"f": "read", "value": None}

    def w(test, ctx):
        return {"f": "add", "value": next(counter)}

    return {
        "client": SetClient(),
        "checker": SetFull(linearizable=True),
        "generator": reserve(5, r, w),
    }
