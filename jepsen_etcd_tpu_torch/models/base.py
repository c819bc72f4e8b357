"""Sequential models for linearizability checking (the knossos.model
protocol the reference relies on via checker/linearizable,
register.clj:110-112, lock.clj:244).

A model is an immutable value with ``step(op) -> Model | Inconsistent``.
Models must be hashable: the search memoizes on (linearized-set, model).
"""

from __future__ import annotations

from typing import Any


class Inconsistent:
    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self):
        return f"<inconsistent: {self.msg}>"


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


class Model:
    def step(self, op) -> "Model | Inconsistent":
        raise NotImplementedError

    # models are value types
    def __eq__(self, other):
        return (type(self) is type(other) and
                self.__getstate__() == other.__getstate__())

    def __hash__(self):
        return hash((type(self).__name__, self.__getstate__()))

    def __getstate__(self):
        raise NotImplementedError
