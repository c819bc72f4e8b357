"""The workload client lifecycle protocol (jepsen.client).

open -> setup -> invoke* -> teardown -> close, driven by the runner;
a worker whose op crashes (:info) gets a fresh client on a fresh process
(jepsen semantics).
"""

from __future__ import annotations

from typing import Any

from ..core.op import Op
from ..client import client as make_client


class WorkloadClient:
    """Subclass and override; self.conn is the connected client."""

    def __init__(self):
        self.conn = None
        self.node = None

    def open(self, test: dict, node: str) -> "WorkloadClient":
        new = self.__class__.__new__(self.__class__)
        new.__dict__.update(self.__dict__)
        new.conn = make_client(test, node)
        new.node = node
        return new

    async def setup(self, test: dict) -> None:
        pass

    async def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    async def teardown(self, test: dict) -> None:
        pass

    def close(self, test: dict) -> None:
        if self.conn is not None:
            self.conn.close()
