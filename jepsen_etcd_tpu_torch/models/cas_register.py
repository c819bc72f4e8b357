"""A plain compare-and-set register (knossos model/cas-register)."""

from __future__ import annotations

from typing import Any

from .base import Model, inconsistent


class CASRegister(Model):
    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def __getstate__(self):
        return self.value

    def __repr__(self):
        return f"reg({self.value})"

    def step(self, op):
        if op.f == "write":
            return CASRegister(op.value)
        if op.f == "cas":
            old, new = op.value
            if self.value != old:
                return inconsistent(f"can't CAS {self.value} from {old}")
            return CASRegister(new)
        if op.f == "read":
            if op.value is not None and op.value != self.value:
                return inconsistent(
                    f"can't read {op.value} from {self.value}")
            return self
        return inconsistent(f"unknown op {op.f}")
