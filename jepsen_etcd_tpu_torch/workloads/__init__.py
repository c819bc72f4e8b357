"""Workload registry (the analog of the workloads map, etcd.clj:33-45).

The port's subset: the workloads whose checkers it has. The set, lock
and MVCC workloads (``set``, ``lock``, ``lock-lease``, ``lock-set``,
``lock-etcd-set``, ``register-stale``, ``ranges``, ``compact-watch``)
come with ``checkers/set_full.py`` and ``checkers/mvcc.py`` (ROADMAP A).
"""

from __future__ import annotations


def workloads() -> dict:
    from . import register, append, wr, watch, none
    return {
        "append": append.workload,
        "none": none.workload,
        "register": register.workload,
        "watch": watch.workload,
        "wr": wr.workload,
    }


#: workloads run by test-all's default sweep (all-workloads,
#: etcd.clj:47-49: everything but :none), filtered to the ported ones
ALL_WORKLOADS = ["append", "register", "watch", "wr"]

#: workloads expected to pass (etcd.clj:51-53), filtered to the ported
#: ones: all four are expected to pass
WORKLOADS_EXPECTED_TO_PASS = ["append", "register", "watch", "wr"]
