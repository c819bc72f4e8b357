"""The append workload's checker, driven as a user drives it.

The system under test is ``jepsen_etcd_tpu_torch.workloads.append.
workload(opts)["checker"]``: ``ListAppendChecker(["strict-serializable"],
device=...)``, Elle's list-append analysis with the closure of Adya's six
planes on the card, checked with ``.check(test, history)``. A history
reaches it as a recorded run's does: a ``History`` over SoA columns,
each op's ``time`` and ``index`` its position. Its verdict comes back as
a host dict; ``summarize`` reads from it what the reference's ``judge``
and the per-layer readers need.
"""

from __future__ import annotations

import numpy as np

from jepsen_etcd_tpu_torch.core.history import History, OpColumns
from jepsen_etcd_tpu_torch.workloads import append

from ..traffic.append_pool import F_TABLE


class Entry:
    def __init__(self, config: dict, device=None):
        opts = {"nodes": [f"n{i + 1}" for i in range(config["nodes"])],
                "concurrency": config["concurrency"]}
        if device is not None:
            opts["device"] = device
        self.opts = opts
        self.checker = append.workload(opts)["checker"]
        self.test = {"name": "benchmark", **opts}

    def history(self, keys: list, i: int) -> History:
        """The one ``PoolHistory`` of ``keys`` as a column-backed
        ``History``."""
        h, = keys
        n = len(h)
        pos = np.arange(n, dtype=np.int64)
        cols = OpColumns(
            h.type_code, np.zeros(n, dtype=np.int32), h.proc,
            np.full(n, -1, dtype=np.int64), pos, pos.copy(), h.values,
            {r: {"error": e} for r, e in h.errors.items()}, {},
            list(F_TABLE), [], [])
        return History.from_columns(cols)

    def check(self, history: History) -> dict:
        return self.checker.check(self.test, history)

    def summarize(self, out: dict, keys: list, i: int) -> dict:
        return summarize(out)


def summarize(out: dict) -> dict:
    """``valid?``, the sorted ``anomaly-types``, ``txn-count`` and
    ``committed-count``, and each certificate a cycle class reported:
    ``{"type", "cycle", "steps"}``, each txn named by the history
    position of its completion."""
    certs = []
    for name, recs in sorted((out.get("anomalies") or {}).items()):
        for r in recs:
            if not (isinstance(r, dict) and "cycle" in r):
                continue
            # a node is named by its txn's completion, its position in
            # the history: the checker's node numbers are its own
            at = {node: t["index"] for node, t in zip(r["cycle"],
                                                      r["txns"])}
            certs.append({
                "type": name, "cycle": [at[x] for x in r["cycle"]],
                "steps": [{"from": at.get(s["from"]),
                           "to": at.get(s["to"]), "type": s["type"]}
                          for s in r["steps"]]})
    return {"valid?": out.get("valid?"),
            "anomaly-types": sorted(out.get("anomaly-types") or []),
            "txn-count": out.get("txn-count"),
            "committed-count": out.get("committed-count"),
            "certificates": certs}
