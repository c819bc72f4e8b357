"""Elle list-append checker (the ``append/test`` analog).

Semantics re-derived from Elle's list-append model as the reference uses
it (append.clj:183-185, ``{:key-count 3 :max-txn-length 4
:consistency-models [:strict-serializable]}``):

- every append value is unique per key, so each ok read of a key — a
  list — reveals that key's version order as a prefix chain;
- reads inside a txn see the txn's own earlier appends (etcd txns apply
  their ops in sequence), so a read's *external* prefix is the list minus
  the txn's own-append suffix;
- dependency edges over committed txns:
    wr  writer(last element of external prefix) -> reader
    ww  writer(v_i) -> writer(v_{i+1}) along each key's version order
    rw  reader of prefix P -> writer(P's successor version)
    rt  T1 completed before T2 invoked (strict-serializable only)
- non-cycle anomalies: duplicate-elements, incompatible-order (reads
  that are not a prefix chain), internal (read contradicts own appends),
  G1a (aborted read: observed a failed txn's append), G1b (intermediate
  read: external prefix ends at a txn's non-final append to that key);
- cycle anomalies G0/G1c/G-single/G2-item (+-realtime) via the batched
  closure on the card (graph.py / ops/closure.py).

Info (indeterminate) txns count as committed iff one of their appends
was observed by an ok read.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Optional

import numpy as np

from ..core import Checker
from .graph import DepGraph, Txn, collect_txns, render_result


def _collect(history) -> list[Txn]:
    txns = collect_txns(history)
    for t in txns:
        for f, k, v in t.mops:
            if f == "append":
                t.appends[k].append(v)
    return txns


class ListAppendChecker(Checker):
    """``use_tpu`` routes the closure as the reference does: None by
    size (the device from ``ops.closure.CPU_CUTOFF`` committed txns),
    True the device, False the host. ``device`` is where the device
    closure runs: ``cuda`` unless the caller passes another (``"cpu"``
    squares in float32 on the CPU); without a card a device closure
    raises."""

    def __init__(self, consistency_models=("strict-serializable",),
                 use_tpu: Optional[bool] = None,
                 device=None):
        self.models = list(consistency_models)
        self.realtime = "strict-serializable" in self.models
        self.use_tpu = use_tpu
        self.device = device

    def check(self, test, history, opts=None) -> dict:
        anomalies: dict[str, list] = defaultdict(list)
        txns = _collect(history)
        writer: dict[tuple, Txn] = {}
        for t in txns:
            for k, vs in t.appends.items():
                for v in vs:
                    if (k, v) in writer:
                        anomalies["duplicate-appends"].append(
                            {"key": k, "value": v})
                    writer[(k, v)] = t

        # -- reads: internal checks + external prefixes ----------------------
        # (k, external-prefix-tuple, reader) triples
        ext_reads: list[tuple] = []
        observed: set = set()  # (k, v) seen in any ok read
        for t in txns:
            if t.status != "ok":
                continue
            own_so_far: dict = defaultdict(list)
            for f, k, v in t.mops:
                if f == "append":
                    own_so_far[k].append(v)
                    continue
                lst = list(v) if v is not None else []
                if len(set(lst)) != len(lst):
                    anomalies["duplicate-elements"].append(
                        {"op": dict(t.op), "mop": [f, k, v]})
                    continue
                own = own_so_far[k]
                if lst[len(lst) - len(own):] != own or len(lst) < len(own):
                    anomalies["internal"].append(
                        {"op": dict(t.op), "mop": [f, k, v],
                         "expected-suffix": list(own)})
                    continue
                ext = lst[:len(lst) - len(own)]
                if any(x in t.appends.get(k, []) for x in ext):
                    anomalies["internal"].append(
                        {"op": dict(t.op), "mop": [f, k, v],
                         "reason": "own append in external prefix"})
                    continue
                for x in ext:
                    observed.add((k, x))
                ext_reads.append((k, tuple(ext), t))

        # -- per-key version order from prefix chains ------------------------
        version_order: dict[Any, list] = {}
        bad_keys: set = set()
        by_key: dict[Any, set] = defaultdict(set)
        for k, ext, _ in ext_reads:
            by_key[k].add(ext)
        for k, prefixes in by_key.items():
            longest = max(prefixes, key=len)
            for p in prefixes:
                if longest[:len(p)] != p:
                    anomalies["incompatible-order"].append(
                        {"key": k, "values": [list(p), list(longest)]})
                    bad_keys.add(k)
            if k not in bad_keys:
                version_order[k] = list(longest)

        # -- aborted / intermediate reads ------------------------------------
        for (k, v) in sorted(observed, key=repr):
            w = writer.get((k, v))
            if w is None:
                anomalies["lost-write"].append(
                    {"key": k, "value": v,
                     "reason": "read a value no txn appended"})
            elif w.status == "fail":
                anomalies["G1a"].append(
                    {"key": k, "value": v, "writer": dict(w.op)})
        for k, ext, t in ext_reads:
            if not ext:
                continue
            last = ext[-1]
            w = writer.get((k, last))
            if w is not None and w.status != "fail" and \
                    w.appends[k] and w.appends[k][-1] != last:
                anomalies["G1b"].append(
                    {"op": dict(t.op), "key": k,
                     "read-prefix": list(ext),
                     "writer-appends": list(w.appends[k])})

        # -- committed node set ----------------------------------------------
        committed = [t for t in txns
                     if t.status == "ok" or
                     (t.status == "info" and
                      any((k, v) in observed for k, vs in t.appends.items()
                          for v in vs))]
        for i, t in enumerate(committed):
            t.node = i
        g = DepGraph(len(committed))

        # ww + rw along version orders
        for k, order in version_order.items():
            for a, b in zip(order, order[1:]):
                wa, wb = writer.get((k, a)), writer.get((k, b))
                if wa is not None and wb is not None and \
                        wa.node is not None and wb.node is not None:
                    g.add("ww", wa.node, wb.node)
        for k, ext, t in ext_reads:
            order = version_order.get(k)
            if t.node is None:
                continue
            if ext:
                w = writer.get((k, ext[-1]))
                if w is not None and w.node is not None:
                    g.add("wr", w.node, t.node)
            if order is not None and len(ext) < len(order):
                succ = writer.get((k, order[len(ext)]))
                if succ is not None and succ.node is not None:
                    g.add("rw", t.node, succ.node)

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
