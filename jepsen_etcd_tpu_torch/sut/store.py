"""The etcd MVCC state machine: a pure, deterministic store.

Models the semantics the reference exercises through jetcd
(``client.clj:405-527`` KV/txn surface, ``append.clj:85-97`` guard
semantics, ``register.clj:31-39`` version bookkeeping, watch event shape at
``watch.clj:156-160``):

- a global ``revision`` counter, bumped once per mutating applied txn;
- per key: ``value``, ``version`` (puts since creation; delete resets),
  ``create_revision``, ``mod_revision``, optional ``lease`` id;
- If/Then/Else transactions whose comparisons read version / value /
  mod_revision / create_revision with ``=``, ``<``, ``>``;
  *absent keys compare with version=0, mod_revision=0, create_revision=0*
  (this is what makes the reference's absent-key guard
  ``(t/< k (t/mod-revision read-revision))`` work, append.clj:93-96);
- tombstoned deletes, compaction (reads/watches below the compact
  revision raise "compacted");
- an event log (per-revision) from which watch streams are served.

The store is the *applied* state of one replica; replication order is the
cluster's job (cluster.py). Pure apply => every replica that applies the
same entries in the same order has an identical store (checked by the
corruption detector).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

from .errors import SimError


# -- txn AST (server side) ---------------------------------------------------

def get_op(key: str) -> tuple:
    return ("get", key)


def put_op(key: str, value: Any, lease: int = 0) -> tuple:
    return ("put", key, value, lease)


def del_op(key: str) -> tuple:
    return ("delete", key)


def range_op(prefix: str) -> tuple:
    """Prefix scan (used by the lock service and debugging)."""
    return ("range", prefix)


def cmp(op: str, key: str, target: str, operand: Any) -> tuple:
    """Comparison: op in {=, <, >}, target in
    {version, value, mod_revision, create_revision}."""
    if op not in ("=", "<", ">"):
        raise ValueError(f"bad cmp op {op!r}")
    if target not in ("version", "value", "mod_revision", "create_revision"):
        raise ValueError(f"bad cmp target {target!r}")
    return (op, key, target, operand)


@dataclass(frozen=True)
class Txn:
    """If(cmps) Then(then_ops) Else(else_ops); plain ops are Txns with no
    compares (executed as the then branch)."""

    cmps: tuple = ()
    then_ops: tuple = ()
    else_ops: tuple = ()


@dataclass
class KeyState:
    value: Any
    version: int
    create_revision: int
    mod_revision: int
    lease: int = 0

    def as_kv(self, key: str) -> dict:
        return {
            "key": key,
            "value": self.value,
            "version": self.version,
            "create-revision": self.create_revision,
            "mod-revision": self.mod_revision,
            "lease": self.lease,
        }


@dataclass
class Event:
    """A watch event (watch.clj:156-160 reads :mod-revision of each kv)."""

    type: str  # "put" | "delete"
    key: str
    kv: Optional[dict]       # state after (None for delete)
    prev_kv: Optional[dict]  # state before (None for create)
    revision: int


class Store:
    """One replica's applied MVCC state."""

    def __init__(self):
        self.revision = 1          # etcd starts at revision 1
        self.compact_revision = 0
        self.kvs: dict[str, KeyState] = {}
        self.events: list[tuple[int, list[Event]]] = []  # (rev, events)
        # clones share the events list copy-on-write (snapshots clone
        # every snapshot_count entries; eagerly copying the whole event
        # history each time is O(history) per snapshot)
        self._events_shared = False
        # lease id -> set of keys currently attached (rebuilt with state)
        self.lease_keys: dict[int, set] = {}

    # -- reads --------------------------------------------------------------

    def get(self, key: str) -> Optional[dict]:
        ks = self.kvs.get(key)
        return ks.as_kv(key) if ks is not None else None

    def range_prefix(self, prefix: str) -> list[dict]:
        out = [ks.as_kv(k) for k, ks in self.kvs.items()
               if k.startswith(prefix)]
        out.sort(key=lambda kv: kv["key"])
        return out

    def range_interval(self, start: str,
                       end: Optional[str] = None) -> list[dict]:
        """etcd Range semantics: end None -> the single key `start`;
        end "\\0" -> every key >= start; else the half-open interval
        [start, end)."""
        if end is None:
            kv = self.get(start)
            return [kv] if kv else []
        out = [ks.as_kv(k) for k, ks in self.kvs.items()
               if k >= start and (end == "\x00" or k < end)]
        out.sort(key=lambda kv: kv["key"])
        return out

    # -- txn evaluation -----------------------------------------------------

    def _cmp_value(self, key: str, target: str) -> Any:
        ks = self.kvs.get(key)
        if ks is None:
            # etcd compares against zero-valued KeyValue for absent keys.
            return None if target == "value" else 0
        return getattr(ks, {"version": "version",
                            "value": "value",
                            "mod_revision": "mod_revision",
                            "create_revision": "create_revision"}[target])

    def check(self, c: tuple) -> bool:
        op, key, target, operand = c
        actual = self._cmp_value(key, target)
        if op == "=":
            return actual == operand
        if actual is None or operand is None:
            return False  # < and > are undefined on nil values
        if op == "<":
            return actual < operand
        return actual > operand

    def apply_txn(self, txn: Txn) -> dict:
        """Apply a transaction; returns
        {succeeded, results, revision, events, mutated}.

        Mutating txns bump the revision by exactly one; all puts/deletes in
        the txn share the new mod_revision (etcd semantics). The caller
        (replica apply loop) is responsible for ordering.
        """
        succeeded = all(self.check(c) for c in txn.cmps)
        ops = txn.then_ops if succeeded else txn.else_ops
        mutates = any(o[0] in ("put", "delete") for o in ops)
        new_rev = self.revision + 1 if mutates else self.revision
        results = []
        events: list[Event] = []
        for o in ops:
            kind = o[0]
            if kind == "get":
                results.append(("get", self.get(o[1])))
            elif kind == "range":
                results.append(("range", self.range_prefix(o[1])))
            elif kind == "put":
                _, key, value, lease = o
                prev = self.kvs.get(key)
                prev_kv = prev.as_kv(key) if prev else None
                # values are immutable by convention once written (every
                # client/workload builds fresh containers per put); a
                # shallow copy guards against top-level reuse without
                # the O(elements) deepcopy that made big-list workloads
                # (set: one ever-growing list) quadratic
                if prev is None:
                    ks = KeyState(value=copy.copy(value), version=1,
                                  create_revision=new_rev,
                                  mod_revision=new_rev, lease=lease)
                else:
                    if prev.lease and prev.lease != lease:
                        self.lease_keys.get(prev.lease, set()).discard(key)
                    ks = KeyState(value=copy.copy(value),
                                  version=prev.version + 1,
                                  create_revision=prev.create_revision,
                                  mod_revision=new_rev, lease=lease)
                self.kvs[key] = ks
                if lease:
                    self.lease_keys.setdefault(lease, set()).add(key)
                results.append(("put", prev_kv))
                events.append(Event("put", key, ks.as_kv(key), prev_kv,
                                    new_rev))
            elif kind == "delete":
                key = o[1]
                prev = self.kvs.pop(key, None)
                prev_kv = prev.as_kv(key) if prev else None
                if prev is not None and prev.lease:
                    self.lease_keys.get(prev.lease, set()).discard(key)
                results.append(("delete", 1 if prev else 0))
                if prev is not None:
                    events.append(Event("delete", key, None, prev_kv,
                                        new_rev))
            else:
                raise ValueError(f"unknown txn op {o!r}")
        if mutates:
            self.revision = new_rev
            if events:
                if self._events_shared:
                    # break COW sharing before the in-place append;
                    # entries are immutable once committed, so a
                    # shallow copy suffices
                    self.events = list(self.events)
                    self._events_shared = False
                self.events.append((new_rev, events))
        return {"succeeded": succeeded, "results": results,
                "revision": self.revision, "events": events,
                "mutated": mutates}

    # -- compaction ---------------------------------------------------------

    def compact(self, rev: int) -> None:
        if rev > self.revision:
            raise SimError("compacted",
                           f"compact revision {rev} > current {self.revision}",
                           definite=True)
        self.compact_revision = max(self.compact_revision, rev)
        # rebuilds (rather than mutates) the list, so sharing clones
        # keep their view; this store's copy is now unshared
        self.events = [(r, evs) for r, evs in self.events
                       if r > self.compact_revision]
        self._events_shared = False

    def events_since(self, rev: int) -> list[Event]:
        """Events with revision >= rev (for watch catch-up).

        Raises compacted if rev is at/below the compact horizon.
        """
        if rev <= self.compact_revision:
            err = SimError("compacted",
                           f"watch from {rev} <= compacted "
                           f"{self.compact_revision}")
            # like etcd's WatchResponse.compact_revision: tells the
            # watcher where it may restart (watch.clj:243-267 retry)
            err.compact_revision = self.compact_revision
            raise err
        out: list[Event] = []
        for r, evs in self.events:
            if r >= rev:
                out.extend(evs)
        return out

    # -- snapshot / state hash ----------------------------------------------

    def state_fingerprint(self) -> int:
        """Deterministic hash of current kv state, for corruption checks
        (the analog of etcd's --experimental-corrupt-check-time).
        Uses crc32 over a canonical encoding — Python's salted hash()
        would break cross-run reproducibility."""
        import zlib
        parts = [f"rev={self.revision}"]
        for k in sorted(self.kvs):
            ks = self.kvs[k]
            parts.append(f"{k}={ks.value!r}:{ks.version}:"
                         f"{ks.create_revision}:{ks.mod_revision}:{ks.lease}")
        return zlib.crc32("\n".join(parts).encode())

    def est_size(self) -> int:
        """Rough byte-size estimate for the db-size stat (picked up by
        wal._est_size when this store sits inside an OBJ-mode snapshot
        record): tracks kv payload and retained-event volume without
        pickling the state."""
        from .wal import _est_size
        import itertools
        sz = 64
        n = len(self.kvs)
        if n:
            sample = itertools.islice(self.kvs.items(), 64)
            per = sum(32 + len(k) + _est_size(ks.value)
                      for k, ks in sample) / min(n, 64)
            sz += int(per * n)
        sz += 24 * len(self.events)
        return sz

    def clone(self) -> "Store":
        new = Store.__new__(Store)
        new.revision = self.revision
        new.compact_revision = self.compact_revision
        # stored values are never mutated in place (puts replace the
        # KeyState wholesale), so clones can share them
        new.kvs = {k: KeyState(v.value, v.version,
                               v.create_revision, v.mod_revision, v.lease)
                   for k, v in self.kvs.items()}
        # events share copy-on-write: (rev, events) entries are
        # immutable once committed, and the first in-place append on
        # either side breaks the sharing
        new.events = self.events
        new._events_shared = True
        self._events_shared = True
        new.lease_keys = {l: set(ks) for l, ks in self.lease_keys.items()}
        return new
