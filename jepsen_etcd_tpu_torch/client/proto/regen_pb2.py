"""Regenerate etcd_rpc_pb2.py without protoc.

The image carries no protoc / grpc_tools, so the generated module is
maintained by this script instead: it loads the current serialized
FileDescriptorProto out of etcd_rpc_pb2.py, (re)applies the message
definitions that were added after the original codegen run, and emits a
fresh etcd_rpc_pb2.py with the same layout protoc produces (serialized
blob + builder calls + pure-python offset table).

Run from the repo root:

    python -m jepsen_etcd_tpu_torch.client.proto.regen_pb2

Idempotent: messages already present are left untouched. Keep
etcd_rpc.proto in sync by hand — it documents the wire contract; this
script is what actually feeds the descriptor pool.
"""

from __future__ import annotations

import os

from google.protobuf import descriptor_pb2

_HERE = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(_HERE, "etcd_rpc_pb2.py")

F = descriptor_pb2.FieldDescriptorProto


def _add_member_add(fdp: descriptor_pb2.FileDescriptorProto) -> bool:
    """etcd's Cluster.MemberAdd request/response (rpc.proto): the one
    cluster RPC the original codegen omitted — member grow needs it."""
    names = {m.name for m in fdp.message_type}
    if "MemberAddRequest" in names:
        return False
    req = fdp.message_type.add()
    req.name = "MemberAddRequest"
    req.field.add(name="peerURLs", number=1,
                  label=F.LABEL_REPEATED, type=F.TYPE_STRING)
    req.field.add(name="isLearner", number=2,
                  label=F.LABEL_OPTIONAL, type=F.TYPE_BOOL)
    resp = fdp.message_type.add()
    resp.name = "MemberAddResponse"
    resp.field.add(name="header", number=1, label=F.LABEL_OPTIONAL,
                   type=F.TYPE_MESSAGE, type_name=".etcdwire.ResponseHeader")
    resp.field.add(name="member", number=2, label=F.LABEL_OPTIONAL,
                   type=F.TYPE_MESSAGE, type_name=".etcdwire.Member")
    resp.field.add(name="members", number=3, label=F.LABEL_REPEATED,
                   type=F.TYPE_MESSAGE, type_name=".etcdwire.Member")
    return True


def _offset_lines(fdp: descriptor_pb2.FileDescriptorProto,
                  blob: bytes) -> list[str]:
    """The pure-python offset table: each descriptor's serialized bytes
    are a contiguous substring of the file blob; find() recovers the
    span protoc would have recorded."""
    lines = []

    def walk(msg: descriptor_pb2.DescriptorProto, prefix: str) -> None:
        sym = f"{prefix}_{msg.name.upper()}"
        sub = msg.SerializeToString()
        idx = blob.find(sub)
        if idx >= 0:
            lines.append(f"  {sym}._serialized_start={idx}")
            lines.append(f"  {sym}._serialized_end={idx + len(sub)}")
        for en in msg.enum_type:
            esub = en.SerializeToString()
            eidx = blob.find(esub)
            if eidx >= 0:
                esym = f"{sym}_{en.name.upper()}"
                lines.append(f"  {esym}._serialized_start={eidx}")
                lines.append(f"  {esym}._serialized_end={eidx + len(esub)}")
        for nested in msg.nested_type:
            walk(nested, sym)

    for m in fdp.message_type:
        walk(m, "")
    return lines


_TEMPLATE = '''# -*- coding: utf-8 -*-
# Generated by regen_pb2.py (protoc-compatible output; no protoc in
# this environment).  DO NOT EDIT BY HAND.
# source: etcd_rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile({blob!r})

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'etcd_rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
{offsets}
# @@protoc_insertion_point(module_scope)
'''


def main() -> int:
    from . import etcd_rpc_pb2 as current

    fdp = descriptor_pb2.FileDescriptorProto.FromString(
        current.DESCRIPTOR.serialized_pb)
    changed = _add_member_add(fdp)
    blob = fdp.SerializeToString()
    out = _TEMPLATE.format(blob=blob,
                           offsets="\n".join(_offset_lines(fdp, blob)))
    with open(_OUT, "w") as f:
        f.write(out)
    print(f"wrote {_OUT} ({'updated' if changed else 'unchanged schema'}, "
          f"{len(blob)} descriptor bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
