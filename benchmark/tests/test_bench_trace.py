"""The trace's reductions on made-up intervals, and on the card a short
traced run of each cell."""

from __future__ import annotations

import json
import os
import time

import pytest

from benchmark.lib.context import union_s
from benchmark.lib.trace import DeviceTrace, innermost, top
from benchmark.run import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]


def test_busy_and_gaps():
    d = DeviceTrace([("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0),
                     ("d", 9.5, 11.0)], 0.0, 10.0)
    assert d.busy() == [[1.0, 3.0], [5.0, 6.0], [9.5, 10.0]]
    assert d.busy_s() == pytest.approx(3.5)
    assert d.gaps() == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.5)]
    assert d.seconds_by_name()["b"] == pytest.approx(1.5)


def test_idle_seconds_go_to_the_innermost_span():
    spans = [("check", 0.0, 10.0), ("linear", 1.0, 6.0),
             ("pack", 1.0, 3.0), ("session", 7.0, 9.0)]
    gaps = [(0.5, 2.0), (4.0, 8.0), (9.5, 11.0)]
    got = innermost(spans, gaps)
    assert got == pytest.approx({"check": 0.5 + 1.0 + 0.5,
                                 "pack": 1.0, "linear": 2.0,
                                 "session": 1.0,
                                 "outside any span": 1.0})
    assert top(got, 2) == [["check", 2.0], ["linear", 2.0]]


def test_union():
    assert union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card(cell):
    """Every cell on the card for a few seconds, traced: correct, the
    device named, the per-layer metrics that can read something read
    it, and a breakdown."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import run
    from benchmark.lib import spec
    c = spec.load(ROOT, cell)
    out = run.run_cell(c, 2 ** 35 + 1, 3.0, True,
                       t_start=time.monotonic())
    print(json.dumps(out))
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert "device_idle_share" in out["metrics"]
    assert out["breakdown"]["device_ops"]
