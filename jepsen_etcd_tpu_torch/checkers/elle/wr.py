"""Elle rw-register checker (the ``wr/test`` analog).

Semantics re-derived from Elle's rw-register model as the reference uses
it (wr.clj:87-92, ``{:key-count 3 :max-txn-length 4
:consistency-models [:strict-serializable] :wfr-keys true}``):

Registers carry opaque (unique per key) values, so version orders are not
directly observable like list prefixes; they are *inferred* from certain
sources only (keeping the checker sound — no false anomalies):

- the initial state ⊥ (a read of nil) precedes every written version;
- writes-follow-reads within one txn (wfr-keys): a txn that externally
  reads k=v1 and then writes k=v2 establishes v1 << v2;
- intra-txn write chains: writing v_a then v_b to the same key in one
  txn establishes v_a << v_b.

From the per-key partial order (transitively closed; a cycle in it is
itself the ``cyclic-version-order`` anomaly):

    wr  writer(v) -> txn that externally read k=v
    ww  writer(v1) -> writer(v2)           for every known v1 << v2
    rw  reader of k=v1 -> writer(v2)       for every known v1 << v2
        (a read of ⊥ precedes every writer of k)
    rt  realtime edges for strict-serializable

plus internal (a txn's read contradicts its own earlier ops), G1a
(reading a failed txn's write), G1b (reading a non-final write of a
committed txn). Cycles via the shared closure on the card (graph.py).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Optional

import numpy as np

from ..core import Checker
from .graph import DepGraph, Txn, collect_txns, render_result


class RWRegisterChecker(Checker):
    """``use_tpu`` routes the closure as the reference does: None by
    size (the device from ``ops.closure.CPU_CUTOFF`` committed txns),
    True the device, False the host. ``device`` is where the device
    closure runs: ``cuda`` unless the caller passes another (``"cpu"``
    squares in float32 on the CPU); without a card a device closure
    raises."""

    def __init__(self, consistency_models=("strict-serializable",),
                 wfr_keys: bool = True, use_tpu: Optional[bool] = None,
                 device=None):
        self.models = list(consistency_models)
        self.realtime = "strict-serializable" in self.models
        self.wfr = wfr_keys
        self.use_tpu = use_tpu
        self.device = device

    def check(self, test, history, opts=None) -> dict:
        anomalies: dict[str, list] = defaultdict(list)
        txns = collect_txns(history)

        # -- writer index + per-txn analysis ---------------------------------
        writer: dict[tuple, Txn] = {}
        for t in txns:
            for f, k, v in t.mops:
                if f == "w":
                    if (k, v) in writer:
                        anomalies["duplicate-writes"].append(
                            {"key": k, "value": v})
                    writer[(k, v)] = t
                    t.writes[k].append(v)

        #: per-key version constraints v1 << v2 (certain sources only)
        vo_edges: dict[Any, set] = defaultdict(set)
        observed: set = set()   # (k, v) read by an ok txn (v may be None)
        for t in txns:
            if t.status != "ok":
                continue
            last_written: dict = {}
            last_read: dict = {}
            for f, k, v in t.mops:
                if f == "w":
                    if k in last_written:
                        vo_edges[k].add((last_written[k], v))
                    elif self.wfr and k in t.ext_reads and \
                            t.ext_reads[k] is not None:
                        vo_edges[k].add((t.ext_reads[k], v))
                    last_written[k] = v
                    continue
                # f == "r"
                if k in last_written:
                    if v != last_written[k]:
                        anomalies["internal"].append(
                            {"op": dict(t.op), "mop": [f, k, v],
                             "expected": last_written[k]})
                    continue
                if k in last_read and last_read[k] != v:
                    anomalies["internal"].append(
                        {"op": dict(t.op), "mop": [f, k, v],
                         "expected": last_read[k],
                         "reason": "non-repeatable read inside txn"})
                last_read[k] = v
                if k not in t.ext_reads:
                    t.ext_reads[k] = v
                    observed.add((k, v))

        # -- aborted / intermediate / phantom reads --------------------------
        for (k, v) in sorted(observed, key=repr):
            if v is None:
                continue
            w = writer.get((k, v))
            if w is None:
                anomalies["lost-write"].append(
                    {"key": k, "value": v,
                     "reason": "read a value no txn wrote"})
            elif w.status == "fail":
                anomalies["G1a"].append(
                    {"key": k, "value": v, "writer": dict(w.op)})
            elif w.writes[k] and w.writes[k][-1] != v:
                anomalies["G1b"].append(
                    {"key": k, "value": v,
                     "writer-writes": list(w.writes[k])})

        # -- per-key version-order closure -----------------------------------
        succ: dict[Any, dict] = {}
        for k, edges in vo_edges.items():
            adj: dict = defaultdict(set)
            for a, b in edges:
                adj[a].add(b)
            closure: dict = {}
            cyclic = False
            for start in list(adj):
                seen: set = set()
                stack = [start]
                while stack:
                    u = stack.pop()
                    for nxt in adj.get(u, ()):
                        if nxt == start:
                            cyclic = True
                        if nxt not in seen:
                            seen.add(nxt)
                            stack.append(nxt)
                closure[start] = seen
            if cyclic:
                anomalies["cyclic-version-order"].append(
                    {"key": k, "edges": sorted(edges)})
            else:
                succ[k] = closure

        # -- committed nodes + dependency edges ------------------------------
        committed = [t for t in txns
                     if t.status == "ok" or
                     (t.status == "info" and
                      any((k, v) in observed for k, vs in t.writes.items()
                          for v in vs))]
        for i, t in enumerate(committed):
            t.node = i
        g = DepGraph(len(committed))

        key_writers: dict[Any, list] = defaultdict(list)
        for (k, v), w in writer.items():
            if w.node is not None:
                key_writers[k].append((v, w))

        for k, closure in succ.items():
            for v1, v2s in closure.items():
                w1 = writer.get((k, v1))
                if w1 is None or w1.node is None:
                    continue
                for v2 in v2s:
                    w2 = writer.get((k, v2))
                    if w2 is not None and w2.node is not None:
                        g.add("ww", w1.node, w2.node)
        for t in committed:
            if t.status != "ok":
                continue
            for k, v in t.ext_reads.items():
                if v is not None:
                    w = writer.get((k, v))
                    if w is not None and w.node is not None:
                        g.add("wr", w.node, t.node)
                    for v2 in succ.get(k, {}).get(v, ()):
                        w2 = writer.get((k, v2))
                        if w2 is not None and w2.node is not None:
                            g.add("rw", t.node, w2.node)
                else:
                    # read of ⊥: every writer of k overwrote what t saw
                    for _, w2 in key_writers.get(k, ()):
                        g.add("rw", t.node, w2.node)

        if self.realtime and committed:
            g.set_realtime(
                np.array([t.invoke_index for t in committed], float),
                np.array([t.complete_index for t in committed], float))

        for rec in g.find_cycles(realtime=self.realtime,
                                 force_device=self.use_tpu,
                                 device=self.device):
            rec = dict(rec)
            rec["txns"] = [dict(committed[i].op) for i in rec["cycle"]]
            anomalies[rec.pop("type")].append(rec)

        out = render_result(dict(anomalies), self.models)
        out["txn-count"] = len(txns)
        out["committed-count"] = len(committed)
        return out
