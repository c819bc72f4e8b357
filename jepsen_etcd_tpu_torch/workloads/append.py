"""Append workload: transactional list-appends, checked by Elle.

Re-design of ``append.clj``: ops are txns of ``["r", k, None]`` /
``["append", k, v]`` micro-ops, executed as an *optimistic two-phase*
etcd transaction:

1. read phase (append.clj:64-83): one txn of gets over the written keys,
   recording each key's value + mod-revision and the header revision;
2. write phase (append.clj:121-158): a guarded If/Then/Else txn —
   per written key present at read time, guard
   ``mod_revision(k) == seen`` ; per absent key, guard
   ``mod_revision(k) < read_revision`` (append.clj:85-97) — whose then
   branch replays the txn, turning each append into a put of the full
   list with the new element conj'd on, playing multi-append state
   forward (append.clj:99-119), and each read into a get.

If the guards fail the op is a definite :fail (:didnt-succeed,
append.clj:156-158). Read results from the write txn are stitched back
into the micro-ops.
"""

from __future__ import annotations

from ..core.op import Op
from ..client import with_errors
from ..client import txn as t
from ..checkers.elle.append import ListAppendChecker
from ..generators.elle import list_append_gen
from .base import WorkloadClient
from .debug import encode_put, decode_get, attach_debug


def ekey(k) -> str:
    return f"a{k}"


class AppendTxnClient(WorkloadClient):
    async def invoke(self, test: dict, op: Op) -> Op:
        async def go():
            mops = op.value
            written = sorted({k for f, k, _ in mops if f == "append"})

            # phase 1: read current state of all written keys
            reads: dict = {}
            read_revision = 0
            if written:
                res = await self.conn.txn([], [t.get(ekey(k))
                                               for k in written])
                read_revision = res["header"]["revision"]
                for k, (_, kv) in zip(written, res["results"]):
                    reads[k] = kv  # kv map or None

            # phase 2: guards + replayed write txn
            guards = []
            for k in written:
                kv = reads[k]
                if kv is not None:
                    guards.append(t.eq(ekey(k),
                                       t.mod_revision(kv["mod-revision"])))
                else:
                    guards.append(t.lt(ekey(k),
                                       t.mod_revision(read_revision)))
            state = {k: list(decode_get(test, kv["value"]))
                     for k, kv in reads.items() if kv is not None}
            ast = []
            for f, k, v in mops:
                if f == "r":
                    ast.append(t.get(ekey(k)))
                else:
                    state[k] = state.get(k, []) + [v]
                    ast.append(t.put(ekey(k),
                                     encode_put(test, op, list(state[k]))))
            res = await self.conn.txn(guards, ast)
            if not res["succeeded"]:
                return attach_debug(test, op.evolve(
                    type="fail", error="didnt-succeed"),
                    read_res={"reads": reads,
                              "read-revision": read_revision},
                    txn_res=res)
            txn_out = []
            for (f, k, v), (_, payload) in zip(mops, res["results"]):
                if f == "append":
                    txn_out.append([f, k, v])
                else:
                    val = decode_get(test, payload["value"]) \
                        if payload else None
                    txn_out.append([f, k, list(val)
                                    if val is not None else None])
            return attach_debug(
                test, op.evolve(type="ok", value=txn_out),
                read_res={"reads": reads, "read-revision": read_revision},
                txn_res=res)

        return await with_errors(op, set(), go)


def workload(opts: dict) -> dict:
    return {
        "client": AppendTxnClient(),
        "checker": ListAppendChecker(
            consistency_models=["strict-serializable"],
            device=opts.get("device")),
        "generator": list_append_gen(key_count=3, max_txn_length=4),
    }
