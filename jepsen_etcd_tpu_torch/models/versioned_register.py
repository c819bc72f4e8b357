"""The versioned register model (register.clj:55-96, line-for-line
semantics, re-expressed).

Op values are ``[version, value]`` pairs; version is the etcd key version
*resulting* from an update (derived client-side from prev-kv,
register.clj:31-39) or the version read. A None version matches anything.
"""

from __future__ import annotations

from typing import Any, Optional

from .base import Model, inconsistent


class VersionedRegister(Model):
    __slots__ = ("version", "value")

    def __init__(self, version: int = 0, value: Any = None):
        self.version = version
        self.value = value

    def __getstate__(self):
        return (self.version, self.value)

    def __repr__(self):
        return f"v{self.version}: {self.value}"

    def step(self, op):
        op_version, op_value = op.value if op.value is not None else (None, None)
        version2 = self.version + 1
        if op.f == "write":
            if op_version is not None and op_version != version2:
                return inconsistent(
                    f"can't go from version {self.version} to {op_version}")
            return VersionedRegister(version2, op_value)
        if op.f == "cas":
            v, v2 = op_value
            if op_version is not None and op_version != version2:
                return inconsistent(
                    f"can't go from version {self.version} to {op_version}")
            if self.value != v:
                return inconsistent(
                    f"can't CAS {self.value} from {v} to {v2}")
            return VersionedRegister(version2, v2)
        if op.f == "read":
            if op_version is not None and op_version != self.version:
                return inconsistent(
                    f"can't read version {op_version} from version "
                    f"{self.version}")
            if op_value is not None and op_value != self.value:
                return inconsistent(
                    f"can't read {op_value} from register {self.value}")
            return self
        return inconsistent(f"unknown op {op.f}")
