"""The register workload's checker, driven as a user drives it.

The system under test is ``jepsen_etcd_tpu_torch.workloads.register.
workload(opts)["checker"]``: ``Independent(Compose({linear:
TPULinearizableChecker, session: SessionGuarantees}))``, checked with
``.check(test, history)``. A history reaches it as a recorded run's
does: a ``History`` over SoA columns, keys relabelled, processes offset
a slot. Its verdict comes back as host dicts; ``summarize`` reads from
them what the reference's ``judge`` and the per-layer readers need.
"""

from __future__ import annotations

import numpy as np

from jepsen_etcd_tpu_torch.core.history import History, OpColumns
from jepsen_etcd_tpu_torch.workloads import register

from ..traffic.register_pool import F_TABLE, PROC_STRIDE

#: key labels of history i start at i * LABEL_STRIDE
LABEL_STRIDE = 1000


class Entry:
    def __init__(self, config: dict, device=None):
        opts = {"nodes": [f"n{i + 1}" for i in range(config["nodes"])],
                "concurrency": config["concurrency"],
                "ops_per_key": config["ops_per_key"]}
        if device is not None:
            opts["device"] = device
        self.opts = opts
        self.checker = register.workload(opts)["checker"]
        self.test = {"name": "benchmark", **opts}

    def history(self, keys: list, i: int) -> History:
        """History ``i``'s column-backed form: slot s of ``keys``
        (``PoolKey``s) under key ``labels(i, keys)[s]`` with its
        processes offset by ``PROC_STRIDE * s``, each op's ``time`` and
        ``index`` its position."""
        label0 = labels(i, keys)[0]
        n = sum(len(k) for k in keys)
        key_id = np.repeat(np.arange(len(keys), dtype=np.int64),
                           [len(k) for k in keys])
        pos = np.arange(n, dtype=np.int64)
        values: list = []
        extras: dict = {}
        at = 0
        for k in keys:
            values += k.values
            for r, err in k.errors.items():
                extras[at + r] = {"error": err}
            at += len(k)
        cols = OpColumns(
            np.concatenate([k.type_code for k in keys]),
            np.concatenate([k.f_code for k in keys]),
            np.concatenate([k.proc + PROC_STRIDE * s
                            for s, k in enumerate(keys)]),
            key_id, pos, pos.copy(), values, extras, {},
            list(F_TABLE), [label0 + s for s in range(len(keys))], [])
        return History.from_columns(cols)

    def check(self, history: History) -> dict:
        return self.checker.check(self.test, history)

    def summarize(self, out: dict, keys: list, i: int) -> dict:
        return summarize(out, labels(i, keys))


def labels(i: int, keys: list) -> list:
    """The key labels of history ``i``: ``LABEL_STRIDE * i`` on."""
    return [LABEL_STRIDE * i + s for s in range(len(keys))]


def summarize(out: dict, labels: list) -> dict:
    """``{"valid?": ..., "keys": [per slot]}`` from the checker's dict:
    for each key label, None where the verdict never came, else its
    linear verdict with the engine that gave it and its waves, and its
    session verdict with the violations counted."""
    results = out.get("results") or {}
    keys = []
    for label in labels:
        r = results.get(label)
        if r is None:
            keys.append(None)
            continue
        lin = r.get("linear") or {}
        ses = r.get("session") or {}
        keys.append({
            "linear": lin.get("valid?"),
            "engine": lin.get("engine") or lin.get("checker"),
            "route": lin.get("engine-route"),
            "batched": bool(lin.get("batched")),
            "waves": lin.get("waves"),
            "session": ses.get("valid?"),
            "violations": ses.get("violation-count", 0),
        })
    extra = len(set(results) - set(labels))
    return {"valid?": out.get("valid?"), "keys": keys, "extra": extra}
