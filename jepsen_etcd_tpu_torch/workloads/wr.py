"""WR workload: transactional register reads/writes, checked by Elle.

Re-design of ``wr.clj``: each op's value is a list of micro-ops
``["r", k, None]`` / ``["w", k, v]``; the whole txn executes as a *single*
etcd transaction (no guards — a batch of gets/puts commits atomically,
wr.clj:37-45), and read results are stitched back into the txn
(wr.clj:63-69). Checked by the Elle rw-register analog with
strict-serializable + wfr-keys (wr.clj:87-92).
"""

from __future__ import annotations

from ..core.op import Op
from ..client import with_errors
from ..client import txn as t
from ..checkers.elle.wr import RWRegisterChecker
from ..generators.elle import rw_register_gen
from .base import WorkloadClient
from .debug import encode_put, decode_get, attach_debug


def ekey(k) -> str:
    return f"w{k}"


class WrTxnClient(WorkloadClient):
    async def invoke(self, test: dict, op: Op) -> Op:
        async def go():
            mops = op.value
            ast = [t.get(ekey(k)) if f == "r"
                   else t.put(ekey(k), encode_put(test, op, v))
                   for f, k, v in mops]
            res = await self.conn.txn([], ast)
            if not res["succeeded"]:
                return attach_debug(test, op.evolve(
                    type="fail", error="didnt-succeed"), txn_res=res)
            txn_out = []
            for (f, k, v), (_, payload) in zip(mops, res["results"]):
                if f == "w":
                    txn_out.append([f, k, v])
                else:
                    txn_out.append(
                        [f, k, decode_get(test, payload["value"])
                         if payload else None])
            return attach_debug(test, op.evolve(type="ok", value=txn_out),
                                txn_res=res)

        return await with_errors(op, set(), go)


def workload(opts: dict) -> dict:
    return {
        "client": WrTxnClient(),
        "checker": RWRegisterChecker(
            consistency_models=["strict-serializable"], wfr_keys=True,
            device=opts.get("device")),
        "generator": rw_register_gen(key_count=3, max_txn_length=4),
    }
