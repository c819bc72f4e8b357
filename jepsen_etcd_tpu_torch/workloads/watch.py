"""Watch workload: watchers must observe identical, ordered value streams.

Re-design of ``watch.clj``: the first node-count threads bump one key
``"w"`` with increasing ints; the remaining threads watch it and log the
value sequences they observe. The checker verifies every watcher saw the
same values in the same order (edit distance vs a canonical log,
watch.clj:328-357) and that no watch stream ever delivered a
non-monotonic revision (watch.clj:161-177 throws a *definite*
``:nonmonotonic-watch`` so the op lands in history as an error).

The final phase converges: every watcher repeatedly re-watches until all
watchers reach the same revision (custom converger barrier,
watch.clj:20-137), with a 60 s cap (watch.clj:245-246).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional

from ..core.op import Op
from ..client import with_errors, client as make_client
from ..checkers.watch import WatchChecker
from ..generators import reserve, each_thread
from ..runner.sim import current_loop, sleep, Event, SECOND
from ..sut.errors import SimError
from .base import WorkloadClient

KEY = "w"
MS = 1_000_000

_INIT = ("init",)
_EVOLVING = ("evolving",)


class ConvergeTimeout(Exception):
    """Deadline passed; carries the thread's partial value."""

    def __init__(self, value):
        super().__init__("converge timeout")
        self.value = value


class ConvergeBroken(Exception):
    """Another participant crashed (the BrokenBarrierException analog)."""


class Converger:
    """N tasks evolve values until (converged? values) holds for all
    non-evolving values and none are initial (watch.clj:20-137)."""

    def __init__(self, n: int, converged: Callable[[list], bool]):
        self.n = n
        self.converged_fn = converged
        self.values: list = [_INIT] * n
        self.crashed = False
        self._next_index = 0
        self._change: Optional[Event] = None

    def _signal(self) -> None:
        if self._change is not None:
            self._change.set()
            self._change = None

    def _stable(self) -> bool:
        return not any(v is _INIT or v is _EVOLVING for v in self.values)

    def _divergent(self) -> bool:
        if any(v is _INIT for v in self.values):
            return True
        vs = [v for v in self.values if v is not _EVOLVING]
        return bool(vs) and not self.converged_fn(vs)

    def _converged(self) -> bool:
        return self._stable() and not self._divergent()

    async def converge(self, timeout_ns: int, init: Any,
                       evolve: Callable) -> Any:
        """Register this task (index = arrival order) and evolve until
        all participants converge. Raises ConvergeTimeout (with the
        partial value) or ConvergeBroken."""
        loop = current_loop()
        deadline = loop.now + timeout_ns
        i = self._next_index
        self._next_index += 1
        while True:
            if self.crashed:
                raise ConvergeBroken("convergence failed")
            if self._converged():
                return self.values[i]
            if loop.now >= deadline:
                raise ConvergeTimeout(self.values[i])
            if self._divergent():
                v = self.values[i]
                v = init if v is _INIT else v
                self.values[i] = _EVOLVING
                try:
                    self.values[i] = await evolve(v)
                except BaseException:
                    self.crashed = True
                    raise
                finally:
                    self._signal()
            else:
                # create the Event synchronously BEFORE yielding: a signal
                # fired between here and the await would otherwise be lost
                if self._change is None:
                    self._change = Event(loop)
                ev = self._change
                timer = loop.call_later(max(0, deadline - loop.now), ev.set)
                try:
                    await ev.wait()
                finally:
                    timer.cancel()


class WatchClient(WorkloadClient):
    def __init__(self):
        super().__init__()
        self.max_revision = [0]      # shared across all opens (an atom)
        self.converger: Optional[Converger] = None

    def open(self, test: dict, node: str) -> "WatchClient":
        new = super().open(test, node)
        new.revision = [0]           # per-client (per-process) revision
        return new

    # -- watch plumbing ------------------------------------------------------

    async def watch_for(self, revision: int, ms: int) -> dict:
        """Watch KEY from revision (exclusive) for ms; returns
        {revision, log} or raises the stream's error
        (watch.clj:139-212)."""
        state = {"revision": revision, "log": [], "revs": []}
        errors: list = []

        def on_events(events):
            if errors:
                return
            # Per-EVENT monotonicity, as the reference checks each event
            # against the last seen revision (watch.clj:161-177) — an
            # intra-batch out-of-order or stale event is an error even if
            # the batch max advances.
            for e in events:
                if not state["revision"] < e.revision:
                    errors.append(SimError(
                        "nonmonotonic-watch",
                        f"got event with revision {e.revision} but we "
                        f"last saw {state['revision']}", definite=True))
                    w.cancel()
                    return
                state["revision"] = e.revision
                state["log"].append(e.kv["value"] if e.kv else None)
                # parallel revision log: lets the checker attribute a
                # missing value to a recorded compaction gap precisely
                state["revs"].append(e.revision)

        def on_error(e):
            errors.append(e)

        # revision is inclusive in the API, so start just past what we
        # have (and never pass 0, which means "from now")
        w = self.conn.watch(KEY, revision + 1, on_events, on_error)
        await sleep(ms * MS)
        w.cancel()
        if errors:
            raise errors[0]
        return state

    def _track(self, res: dict) -> None:
        self.revision[0] = res["revision"]
        self.max_revision[0] = max(self.max_revision[0], res["revision"])

    def _failover(self, test: dict) -> None:
        """Re-pin the connection to a current member. jetcd is built
        with EVERY endpoint and its channel fails over internally when
        a member dies or is removed (client.clj's connect takes the
        full node list); the sim client pins one node, so a watcher
        whose node was shrunk away would otherwise retry connect-failed
        until the converger times out (-> unknown)."""
        db = test.get("db")
        members = sorted(getattr(db, "members", None) or test["nodes"])
        others = [m for m in members if m != self.node] or members
        if not others:
            return
        loop = current_loop()
        new = others[loop.rng.randrange(len(others))]
        try:
            self.conn.close()
        except Exception:
            pass
        self.conn = make_client(test, new)
        self.node = new

    # -- ops -----------------------------------------------------------------

    async def invoke(self, test: dict, op: Op) -> Op:
        loop = current_loop()

        async def go():
            if op.f == "write":
                res = await self.conn.put(KEY, op.value)
                self.max_revision[0] = max(self.max_revision[0],
                                           res["header"]["revision"])
                return op.evolve(type="ok")

            if op.f == "watch":
                res = await self.watch_for(self.revision[0],
                                           loop.rng.randint(0, 5000))
                self._track(res)
                return op.evolve(type="ok", value=res)

            if op.f == "final-watch":
                violations: list = []

                async def evolve(v):
                    try:
                        w = await self.watch_for(
                            v["revision"], loop.rng.randint(0, 5000))
                        self._track(w)
                        return {"revision": w["revision"],
                                "log": v["log"] + w["log"],
                                "revs": v.get("revs", []) + w["revs"],
                                "gaps": v.get("gaps", [])}
                    except (SimError, TimeoutError) as e:
                        # the reference retries EVERY client error here
                        # (watch.clj:258-261 catches client-error?) — a
                        # raise would crash the whole converger; a stuck
                        # watcher surfaces as converge-timeout instead.
                        # A monotonicity violation is retried too, but
                        # the evidence is preserved on the op (the
                        # reference silently drops it here).
                        if isinstance(e, SimError) and \
                                e.type == "nonmonotonic-watch":
                            violations.append(str(e))
                        if isinstance(e, SimError) and \
                                e.type == "connect-failed":
                            # node dead or shrunk away: fail over like
                            # jetcd's multi-endpoint channel would
                            self._failover(test)
                        if isinstance(e, SimError) and \
                                e.type == "compacted":
                            # a watch below the compact horizon can NEVER
                            # proceed: retrying the same revision stalls
                            # the converger until timeout (-> unknown).
                            # Restart past the horizon and record the
                            # unobservable window so the checker can
                            # attribute the missing entries
                            # (watch.clj:243-267 semantics; etcd's
                            # WatchResponse.compact_revision restart).
                            new_rev = getattr(e, "compact_revision", None)
                            if new_rev is None:
                                new_rev = self.max_revision[0]
                            if new_rev > v["revision"]:
                                self.revision[0] = new_rev
                                return {
                                    "revision": new_rev,
                                    "log": v["log"],
                                    "revs": v.get("revs", []),
                                    "gaps": v.get("gaps", []) +
                                            [[v["revision"], new_rev]]}
                        await sleep(1 * SECOND)
                        return v

                def done(type_, value, extra_error=None):
                    err = None
                    if violations:
                        err = ["nonmonotonic-watch"] + violations[:4]
                    elif extra_error:
                        err = extra_error
                    return op.evolve(type=type_, value=value,
                                     **({"error": err} if err else {}))

                try:
                    v = await self.converger.converge(
                        60 * SECOND,
                        {"revision": self.revision[0], "log": []}, evolve)
                    return done("ok", v)
                except ConvergeTimeout as e:
                    val = None if e.value in (_INIT, _EVOLVING) else e.value
                    return done("ok", val,
                                extra_error=["converge-timeout"])
            raise ValueError(f"unknown f {op.f}")

        async def go_with_failover():
            # every op re-pins on connect-failed (jetcd's channel fails
            # over for ALL calls, not just final-watch retries); the op
            # itself still fails honestly — the NEXT op uses the new
            # member
            try:
                return await go()
            except SimError as e:
                if e.type == "connect-failed":
                    self._failover(test)
                raise

        # watch ops must fail definitely: an indefinite error would spin
        # up a fresh client whose re-watch duplicates log entries
        return await with_errors(op, {"watch", "final-watch"},
                                 go_with_failover)


def workload(opts: dict) -> dict:
    node_count = len(opts["nodes"])
    concurrency = opts.get("concurrency") or 2 * node_count
    watch_count = max(1, concurrency - node_count)
    client = WatchClient()

    def converged(ms: list) -> bool:
        # all watchers agree AND have reached the highest revision any
        # writer observed — equality alone would let every watcher
        # converge at the same stale revision, masking a common-tail loss
        revs = {m["revision"] for m in ms}
        return len(revs) == 1 and min(revs) >= client.max_revision[0]

    client.converger = Converger(watch_count, converged)
    counter = itertools.count()

    def write(test, ctx):
        return {"f": "write", "value": next(counter)}

    def watch(test, ctx):
        return {"f": "watch", "value": None}

    return {
        "client": client,
        "checker": WatchChecker(device=opts.get("device")),
        "generator": reserve(node_count, write, watch),
        "final_generator": reserve(
            node_count, None, each_thread({"f": "final-watch"})),
    }
