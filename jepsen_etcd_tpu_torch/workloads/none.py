"""The no-op workload (tests/noop-test analog, etcd.clj:41): a null
client/generator for smoke-testing DB automation and nemeses alone."""

from __future__ import annotations

from ..checkers.core import Noop
from .base import WorkloadClient


class NoopClient(WorkloadClient):
    async def invoke(self, test, op):
        return op.evolve(type="ok")


def workload(opts: dict) -> dict:
    return {"client": NoopClient(), "checker": Noop(), "generator": None}
