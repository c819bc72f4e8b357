"""MVCC consistency-surface workloads: bounded-staleness reads,
snapshot ranges, compaction-vs-watch stress.

Three of the four consumers of the MVCC model (core/mvcc.py) — the
fourth, lease churn, extends workloads/lock.py. Each workload trades
the linearizable register's strong claim for a *weaker, still
falsifiable* one (ROADMAP direction 1: the judged raft bug lives in
exactly these surfaces), checked by checkers/mvcc.py:

- ``register-stale``: reads are **serializable** (node-local, so
  legitimately stale under partition) over a small fixed key set; ops
  carry ``[key, version, value]`` so the checker can bound the
  staleness instead of demanding linearizability.
- ``ranges``: writers bump per-key versions while readers fetch ALL
  keys in one txn (the pagination analog); a range must observe a
  version vector that was current at some instant.
- ``compact-watch``: writers bump one key, a dedicated thread
  compacts aggressively behind the head, and watchers log the
  revision streams they observe — recording an explicit gap whenever
  a compaction forces a restart past the horizon, so every missing
  event is attributable.
"""

from __future__ import annotations

from ..core.op import Op
from ..client import with_errors
from ..client import txn as t
from ..checkers import compose
from ..checkers.mvcc import (BoundedStaleness, CompactionWatch,
                             SnapshotRanges)
from ..generators import reserve
from ..runner.sim import current_loop, sleep
from ..sut.errors import SimError
from .base import WorkloadClient

MS = 1_000_000

#: revisions retained behind the head on each compaction (aggressive:
#: watchers that lag by more than this cross the horizon)
DEFAULT_COMPACT_KEEP = 8


def _key_count(opts: dict) -> int:
    conc = opts.get("concurrency") or 2 * len(opts["nodes"])
    return max(2, int(conc) // 4)


# -- register-stale ----------------------------------------------------------

class RegisterStaleClient(WorkloadClient):
    """Serializable reads + writes on fixed keys ``s0..s{K-1}``; ops
    carry flat ``[key, version, value]`` payloads."""

    async def invoke(self, test: dict, op: Op) -> Op:
        k = op.value[0]
        key = f"s{k}"

        async def go():
            if op.f == "read":
                kv = await self.conn.get(key, serializable=True)
                if kv:
                    return op.evolve(type="ok",
                                     value=[k, kv["version"], kv["value"]])
                return op.evolve(type="ok", value=[k, 0, None])
            if op.f == "write":
                v = op.value[2]
                r = await self.conn.put(key, v)
                prev = r.get("prev-kv")
                ver = (prev["version"] if prev else 0) + 1
                return op.evolve(type="ok", value=[k, ver, v])
            raise ValueError(f"unknown f {op.f}")

        return await with_errors(op, {"read"}, go)


def workload(opts: dict) -> dict:
    """Bounded-staleness register: half the threads are a reserved
    serializable-read pool, the rest write; the checker verifies the
    staleness surface instead of linearizability."""
    n = len(opts["nodes"])
    conc = opts.get("concurrency") or 2 * n
    readers = max(1, conc // 2)
    keys = _key_count(opts)

    def r(test, ctx):
        return {"f": "read", "value": [ctx.rng.randrange(keys), None, None]}

    def w(test, ctx):
        return {"f": "write", "value": [ctx.rng.randrange(keys), None,
                                        ctx.rng.randint(0, 4)]}

    return {
        "client": RegisterStaleClient(),
        "checker": compose({"staleness": BoundedStaleness()}),
        "generator": reserve(readers, r, w),
    }


# -- ranges ------------------------------------------------------------------

class RangesClient(WorkloadClient):
    """Writers bump ``g0..g{K-1}``; a range reads ALL keys in one txn
    (leader-atomic), acking ``[[key, version], ...]``."""

    def __init__(self, keys: int):
        super().__init__()
        self.keys = keys

    async def invoke(self, test: dict, op: Op) -> Op:
        async def go():
            if op.f == "range":
                gets = [t.get(f"g{i}") for i in range(self.keys)]
                res = await self.conn.txn([], gets)
                vec = [[i, kv["version"] if kv else 0]
                       for i, kv in enumerate(res["gets"])]
                return op.evolve(type="ok", value=vec)
            if op.f == "write":
                k, _, v = op.value
                r = await self.conn.put(f"g{k}", v)
                prev = r.get("prev-kv")
                ver = (prev["version"] if prev else 0) + 1
                return op.evolve(type="ok", value=[k, ver, v])
            raise ValueError(f"unknown f {op.f}")

        return await with_errors(op, {"range"}, go)


def ranges_workload(opts: dict) -> dict:
    """Snapshot-consistency ranges: multi-key reads must not tear
    across a revision boundary."""
    n = len(opts["nodes"])
    conc = opts.get("concurrency") or 2 * n
    readers = max(1, conc // 2)
    keys = _key_count(opts)

    def rng_gen(test, ctx):
        return {"f": "range", "value": None}

    def w(test, ctx):
        return {"f": "write", "value": [ctx.rng.randrange(keys), None,
                                        ctx.rng.randint(0, 4)]}

    return {
        "client": RangesClient(keys),
        "checker": compose({"ranges": SnapshotRanges()}),
        "generator": reserve(readers, rng_gen, w),
    }


# -- compact-watch -----------------------------------------------------------

KEY = "cw"


class CompactWatchClient(WorkloadClient):
    """Writers bump KEY acking ``[revision, value]``; a compactor
    trails the head by ``compact_keep`` revisions; watchers log the
    revision streams they observe, recording explicit gaps whenever a
    compaction forces a restart past the horizon."""

    def open(self, test: dict, node: str) -> "CompactWatchClient":
        new = super().open(test, node)
        new.last_seen = [0]          # per-process watch cursor
        return new

    async def _watch_once(self, ms: int) -> dict:
        from_rev = self.last_seen[0]
        state = {"rev": from_rev, "revs": [], "log": []}
        gaps: list = []
        errors: list = []

        def on_events(events):
            if errors:
                return
            for e in events:
                state["rev"] = max(state["rev"], e.revision)
                state["revs"].append(e.revision)
                state["log"].append(e.kv["value"] if e.kv else None)

        def on_error(e):
            errors.append(e)

        w = self.conn.watch(KEY, state["rev"] + 1, on_events, on_error)
        await sleep(ms * MS)
        w.cancel()
        if errors:
            e = errors[0]
            if isinstance(e, SimError) and e.type == "compacted":
                # unobservable window: record it so the checker can
                # attribute the missing revisions, restart past it
                new_rev = getattr(e, "compact_revision", None)
                if new_rev and new_rev > state["rev"]:
                    gaps.append([state["rev"], new_rev])
                    state["rev"] = new_rev
            else:
                raise e
        self.last_seen[0] = state["rev"]
        return {"from": from_rev, "revs": state["revs"], "gaps": gaps,
                "log": state["log"]}

    async def invoke(self, test: dict, op: Op) -> Op:
        loop = current_loop()
        keep = int(test.get("compact_keep") or DEFAULT_COMPACT_KEEP)

        async def go():
            if op.f == "write":
                res = await self.conn.put(KEY, op.value)
                return op.evolve(
                    type="ok",
                    value=[res["header"]["revision"], op.value])
            if op.f == "compact":
                rev = await self.conn.revision()
                target = rev - keep
                if target >= 1:
                    await self.conn.compact(target, physical=True)
                    return op.evolve(type="ok", value=target)
                return op.evolve(type="ok", value=0)
            if op.f == "watch":
                res = await self._watch_once(loop.rng.randint(0, 3000))
                return op.evolve(type="ok", value=res)
            raise ValueError(f"unknown f {op.f}")

        # watch/compact must fail definitely: an indefinite watch
        # would re-deliver its window through a fresh process
        return await with_errors(op, {"watch", "compact"}, go)


def compact_watch_workload(opts: dict) -> dict:
    """Compaction-vs-watch stress: one thread compacts aggressively
    behind the head while watchers lag; every lost event must be
    attributable to a compaction."""
    import itertools
    n = len(opts["nodes"])
    conc = opts.get("concurrency") or 2 * n
    writers = max(1, min(n, conc - 2))
    counter = itertools.count()

    def write(test, ctx):
        return {"f": "write", "value": next(counter)}

    def compact(test, ctx):
        return {"f": "compact", "value": None}

    def watch(test, ctx):
        return {"f": "watch", "value": None}

    return {
        "client": CompactWatchClient(),
        "checker": compose({"watch-mvcc": CompactionWatch()}),
        "generator": reserve(1, compact, writers, write, watch),
    }
