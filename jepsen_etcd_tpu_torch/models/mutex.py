"""The mutex model (knossos model/mutex, used at lock.clj:244)."""

from __future__ import annotations

from .base import Model, inconsistent


class Mutex(Model):
    __slots__ = ("locked",)

    def __init__(self, locked: bool = False):
        self.locked = locked

    def __getstate__(self):
        return self.locked

    def __repr__(self):
        return "locked" if self.locked else "unlocked"

    def step(self, op):
        if op.f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a held lock")
            return Mutex(True)
        if op.f == "release":
            if not self.locked:
                return inconsistent("cannot release a free lock")
            return Mutex(False)
        return inconsistent(f"unknown op {op.f}")
