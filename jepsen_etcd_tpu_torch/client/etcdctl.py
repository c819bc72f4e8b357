"""The etcdctl-style text client backend.

The reference keeps a second client that SSHes to a node and drives the
``etcdctl`` binary with a *textual* txn syntax, proving clients are
swappable behind the 1-method seam (``client/etcdctl.clj``, seam at
``client/support.clj:4-6``). We preserve that seam: this backend compiles
the txn AST to etcdctl's text format (``txn->text``,
client/etcdctl.clj:125-165 — note the inverted comparison syntax
``mod("k") < 5``), round-trips it through a parser (the "binary"), and
only then executes — so a compiler/parser bug surfaces exactly like an
etcdctl incompatibility would. Values cross the text boundary as JSON
(the analog of the base64+EDN re-reading at client/etcdctl.clj:73-123).

Per-client command logs mirror the reference's per-client log files
(client/etcdctl.clj:175-196, stored via store/path!).
"""

from __future__ import annotations

import json
from typing import Any

from .base import Client
from ..sut.store import Txn
from ..sut.errors import SimError


def _enc(v: Any) -> str:
    return json.dumps(v, sort_keys=True, default=repr)


def _dec(s: str) -> Any:
    return json.loads(s)


TARGET_FNS = {"version": "ver", "value": "val", "mod_revision": "mod",
              "create_revision": "create"}
FN_TARGETS = {v: k for k, v in TARGET_FNS.items()}


def txn_to_text(txn: Txn) -> str:
    """Serialize a server-shape Txn to etcdctl's interactive txn format."""
    lines = ["compares:"]
    for (op, key, target, operand) in txn.cmps:
        fn = TARGET_FNS[target]
        lines.append(f'{fn}("{key}") {op} {_enc(operand)}')
    lines.append("")
    lines.append("success requests:")
    for o in txn.then_ops:
        lines.append(_op_text(o))
    lines.append("")
    lines.append("failure requests:")
    for o in txn.else_ops:
        lines.append(_op_text(o))
    lines.append("")
    return "\n".join(lines)


def _op_text(o: tuple) -> str:
    if o[0] == "get":
        return f'get "{o[1]}"'
    if o[0] == "put":
        lease = f" --lease={o[3]:x}" if len(o) > 3 and o[3] else ""
        return f'put "{o[1]}" {_enc(o[2])}{lease}'
    if o[0] == "delete":
        return f'del "{o[1]}"'
    raise ValueError(f"cannot serialize op {o!r}")


def text_to_txn(text: str) -> Txn:
    """Parse the etcdctl txn text back into the server shape."""
    section = None
    cmps: list = []
    then_ops: list = []
    else_ops: list = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line == "compares:":
            section = "cmp"
            continue
        if line == "success requests:":
            section = "then"
            continue
        if line == "failure requests:":
            section = "else"
            continue
        if section == "cmp":
            cmps.append(_parse_cmp(line))
        elif section in ("then", "else"):
            target = then_ops if section == "then" else else_ops
            target.append(_parse_op(line))
        else:
            raise SimError("unavailable", f"etcdctl parse error: {line!r}",
                           definite=True)
    return Txn(tuple(cmps), tuple(then_ops), tuple(else_ops))


def _parse_cmp(line: str) -> tuple:
    # e.g.: mod("key") = 5
    fn, rest = line.split("(", 1)
    key_part, rest = rest.split(")", 1)
    key = json.loads(key_part)
    rest = rest.strip()
    op = rest[0]
    operand = _dec(rest[1:].strip())
    return (op, key, FN_TARGETS[fn.strip()], operand)


def _parse_op(line: str) -> tuple:
    parts = line.split(None, 1)
    kind = parts[0]
    rest = parts[1] if len(parts) > 1 else ""
    if kind == "get":
        return ("get", json.loads(rest))
    if kind == "del":
        return ("delete", json.loads(rest))
    if kind == "put":
        lease = 0
        if " --lease=" in rest:
            rest, lease_s = rest.rsplit(" --lease=", 1)
            lease = int(lease_s, 16)
        # key is the first JSON string; value is the remainder
        decoder = json.JSONDecoder()
        key, at = decoder.raw_decode(rest)
        value = _dec(rest[at:].strip())
        return ("put", key, value, lease)
    raise ValueError(f"cannot parse op line {line!r}")


class EtcdctlClient(Client):
    """Txn-only text backend (like the reference's etcdctl client, which
    implements only the txn seam, client/etcdctl.clj:170-217)."""

    def __init__(self, cluster, node):
        super().__init__(cluster, node)
        self.log: list[str] = []  # per-client command log

    async def _txn_rpc(self, txn: Txn) -> dict:
        text = txn_to_text(txn)
        self.log.append(text)
        parsed = text_to_txn(text)
        # values crossed a JSON boundary; results come back as JSON types
        raw = await self._call(self.cluster.kv_txn(self.node, parsed))
        self.log.append(json.dumps({"succeeded": raw["succeeded"],
                                    "revision": raw["revision"]}))
        return raw
