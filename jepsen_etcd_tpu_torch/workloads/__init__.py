"""Workload registry (the analog of the workloads map, etcd.clj:33-45):
the reference's thirteen names, the same factories. A factory reads
``opts["device"]`` where its checker runs a kernel (register, lock,
watch, and the Elle checkers of append and wr)."""

from __future__ import annotations


def workloads() -> dict:
    from . import (register, set as set_wl, append, wr, watch, lock,
                   mvcc, none)
    return {
        "append": append.workload,
        "compact-watch": mvcc.compact_watch_workload,
        "lock": lock.workload,
        "lock-lease": lock.lease_workload,
        "lock-set": lock.set_workload,
        "lock-etcd-set": lock.etcd_set_workload,
        "none": none.workload,
        "ranges": mvcc.ranges_workload,
        "register": register.workload,
        "register-stale": mvcc.workload,
        "set": set_wl.workload,
        "watch": watch.workload,
        "wr": wr.workload,
    }


#: workloads run by test-all's default sweep (all-workloads,
#: etcd.clj:47-49: everything but :none)
ALL_WORKLOADS = [
    "append", "compact-watch", "lock", "lock-etcd-set", "lock-lease",
    "lock-set", "ranges", "register", "register-stale", "set",
    "watch", "wr"]

#: workloads expected to pass (etcd.clj:51-53): removes only :lock and
#: :lock-set — lock-etcd-set's txn guard (version(lock_key) > 0) makes it
#: safe enough to pass, and empirically it does in the sim too. The MVCC
#: consistency surfaces (register-stale, ranges, lock-lease,
#: compact-watch) check claims weak enough to survive the fault matrix:
#: bounded staleness excuses fault-window lag, lease holds are clipped
#: at the TTL, and watch losses are attributable to recorded
#: compactions — so all four are expected to pass.
WORKLOADS_EXPECTED_TO_PASS = [
    "append", "compact-watch", "lock-etcd-set", "lock-lease", "ranges",
    "register", "register-stale", "set", "watch", "wr"]
