"""Nemesis packages: composed fault injectors (nemesis.clj analog).

A package is {nemesis, generator, final_generator, perf} (the jepsen
nemesis.combined shape, composed at nemesis.clj:200-209). The full fault
suite (kill/pause/partition/clock/member/corrupt/admin) builds here from
the db and cluster fault APIs.
"""

from __future__ import annotations

from typing import Any, Optional

from ..core.op import Op


class Nemesis:
    """Base nemesis: setup/invoke/teardown against the test's cluster."""

    async def setup(self, test: dict) -> None:
        pass

    async def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    async def teardown(self, test: dict) -> None:
        pass


class NoopNemesis(Nemesis):
    async def invoke(self, test, op):
        return op.evolve(type="info")


def nemesis_package(opts: dict) -> dict:
    """Build the composed package for opts['nemesis'] fault names
    (parse-nemesis-spec / special-nemeses analog, etcd.clj:75-88)."""
    faults = set(opts.get("nemesis") or [])
    if not faults or faults == {"none"}:
        return {"nemesis": None, "generator": None,
                "final_generator": None, "perf": []}
    from .faults import build_packages
    return build_packages(opts, faults)
