"""History forensics: REPL helpers over saved stores.

Re-designs the reference's list-append investigation toolkit
(``etcd.clj:259-346``), written to debug an etcdctl client leaking state
between test runs: given debug-mode histories (whose written values
carry provenance, workloads/debug.py), these extract which *runs* the
values read back came from (``txn_dirs`` — a value from a different
run's dir is the smoking gun), and find duplicate mod-revisions for the
same (key, value) (``duplicate_revisions``).

Works over live History objects or saved stores (``load_history``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Iterable, Optional

from .core.history import History


def load_history(run_dir: str) -> History:
    """Read a saved run's history.jsonl."""
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        return History.from_jsonl(f.read())


def all_runs(store_base: str = "store") -> list[str]:
    """All saved run dirs under a store base, oldest first
    (store/all-tests analog, etcd.clj:283)."""
    out = []
    if not os.path.isdir(store_base):
        return out
    for test_name in sorted(os.listdir(store_base)):
        tdir = os.path.join(store_base, test_name)
        if not os.path.isdir(tdir) or test_name == "latest":
            continue
        for run in sorted(os.listdir(tdir)):
            rdir = os.path.join(tdir, run)
            if run != "latest" and os.path.isdir(rdir) and \
                    os.path.exists(os.path.join(rdir, "history.jsonl")):
                out.append(rdir)
    return out


def _debug_values(res: Any) -> Iterable[dict]:
    """Yield provenance-wrapped values out of a raw txn result."""
    if not isinstance(res, dict):
        return
    for entry in res.get("results", ()):
        if not (isinstance(entry, (list, tuple)) and len(entry) == 2):
            continue
        _, payload = entry
        if isinstance(payload, dict):
            v = payload.get("value")
            if isinstance(v, dict) and "dir" in v:
                yield v


def txn_dirs(history) -> set:
    """Set of store-dir names seen in any txn's read results
    (txn-dirs, etcd.clj:265-276): values read from a *different* run's
    dir prove state leaked across runs."""
    dirs = set()
    for op in history:
        dbg = op.get("debug")
        if not isinstance(dbg, dict):
            continue
        for res_key in ("read-res", "txn-res"):
            res = dbg.get(res_key)
            if res_key == "read-res" and isinstance(res, dict):
                # append's phase-1 shape: {"reads": {k: kv}, ...}
                for kv in (res.get("reads") or {}).values():
                    if isinstance(kv, dict) and isinstance(
                            kv.get("value"), dict) and \
                            "dir" in kv["value"]:
                        dirs.add(kv["value"]["dir"])
            else:
                for v in _debug_values(res):
                    dirs.add(v["dir"])
    return dirs


def all_txn_dirs(store_base: str = "store") -> dict:
    """Map run dir -> txn_dirs(history) for every saved run with any
    (all-txns-dirs, etcd.clj:279-289)."""
    out = {}
    for rdir in all_runs(store_base):
        dirs = txn_dirs(load_history(rdir))
        if dirs:
            out[rdir] = dirs
    return out


def ops_involving(k, history) -> list:
    """Ops whose txn touches key k (ops-involving, etcd.clj:291-300)."""
    out = []
    for op in history:
        if op.get("f") != "txn":
            continue
        v = op.get("value")
        if isinstance(v, (list, tuple)) and any(
                isinstance(m, (list, tuple)) and len(m) >= 2 and m[1] == k
                for m in v):
            out.append(op)
    return out


def wr_op_revisions(op) -> list:
    """Revision maps from one debug-mode txn op
    (wr-op-revisions, etcd.clj:302-330):

        {"type": "w"|"r", "index": op index, "key": k,
         "value": v, "mod-revision": r}

    writes report their prev-kv (the state they overwrote); reads report
    the kv they observed."""
    dbg = op.get("debug")
    if not isinstance(dbg, dict):
        return []
    res = dbg.get("txn-res")
    if not isinstance(res, dict):
        return []
    out = []
    for entry in res.get("results", ()):
        if not (isinstance(entry, (list, tuple)) and len(entry) == 2):
            continue
        kind, payload = entry
        if payload is None or not isinstance(payload, dict):
            continue
        v = payload.get("value")
        if isinstance(v, dict) and "value" in v:
            v = v["value"]  # strip provenance wrapper
        out.append({
            "type": "w" if kind == "put" else "r",
            "index": op.get("index"),
            "key": payload.get("key"),
            "value": v,
            "mod-revision": payload.get("mod-revision"),
        })
    return out


def wr_ops_revisions(ops) -> list:
    """All revision maps from many ops (etcd.clj:332-335)."""
    out = []
    for op in ops:
        out.extend(wr_op_revisions(op))
    return out


def duplicate_revisions(ops) -> dict:
    """(key, value) -> revision maps, where the same (key, value) pair
    appears under more than one mod-revision (duplicate-revisions,
    etcd.clj:337-346) — on a healthy etcd each written value gets one
    revision, so duplicates expose cross-run leakage or lost updates."""
    by_kv: dict = defaultdict(list)
    for rm in wr_ops_revisions(ops):
        if rm["key"] is not None:
            by_kv[(rm["key"], json.dumps(rm["value"], default=repr,
                                         sort_keys=True))].append(rm)
    return {kv: rms for kv, rms in sorted(by_kv.items())
            if len({rm["mod-revision"] for rm in rms}) > 1}
