"""A whole run with the system broken underneath reads not correct.

Each test drives ``run_cell`` past its look for a card (the system on
the CPU, at a size a test holds) with one fault planted in the
program: a check that returns its earlier state, half of a history's
keys left out with the rest's verdicts standing in for them, and one
verdict altered where it is produced. The exchange between cards does
not exist in a one-card cell.
"""

from __future__ import annotations

import copy
import time

import pytest

from jepsen_etcd_tpu_torch.checkers import independent, tpu_linearizable

from benchmark import run
from benchmark.lib import spec

TINY = {"ops_per_key": 300, "keys_per_history": [12, 12],
        "pool": {"clean": 12, "corrupt": 4, "faulted": 2},
        "corrupt_every": 1, "info_rate": 0.05,
        "warmup": [{"keys": 12, "faulted": 1, "corrupt": 1}]}


def _run(seed=2 ** 33 + 9):
    cell = spec.load(run.ROOT, "register_4n_2000.faulted")
    cell.spec["params"].update(copy.deepcopy(TINY))
    return run.run_cell(cell, seed, 8.0, False, device="cpu",
                        t_start=time.monotonic())


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "compared"


def _stale(monkeypatch):
    real = independent.Independent.check
    first = {}

    def check(self, test, history, opts=None):
        out = real(self, test, history, opts)
        if "out" not in first:
            first["out"] = out
            return out
        # the first verdict again, under this history's key labels
        old = list(first["out"]["results"].values())
        return dict(first["out"], results=dict(zip(out["results"], old)))

    monkeypatch.setattr(independent.Independent, "check", check)


def _half(monkeypatch):
    real = independent.Independent.check

    def check(self, test, history, opts=None):
        out = real(self, test, history, opts)
        keys = list(out["results"])
        kept = keys[:len(keys) // 2]
        results = {k: out["results"][kept[j % len(kept)]]
                   for j, k in enumerate(keys)}
        valid = all(r["valid?"] is True for r in results.values())
        return dict(out, results=results, **{"valid?": valid})

    monkeypatch.setattr(independent.Independent, "check", check)


def _altered(monkeypatch):
    real = tpu_linearizable.TPULinearizableChecker.check_batch

    def check_batch(self, test, subhistories, opts=None):
        out = real(self, test, subhistories, opts)
        k = next(iter(out))
        out[k] = dict(out[k], **{"valid?": not out[k]["valid?"]})
        return out

    monkeypatch.setattr(tpu_linearizable.TPULinearizableChecker,
                        "check_batch", check_batch)


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
def test_a_broken_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run()
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())
