"""The port's Elle checkers (``checkers/elle/``) against the reference's
on the CPU: every input of the reference's ``tests/test_elle.py``
(rebuilt here), the synthesized list-append and rw-register histories
of ``testing.py`` clean and with a planted anomaly, and a history just
above the closure's ``CPU_CUTOFF``, each through both packages'
checkers with the closure on the host and on the device route (the
reference's JAX on the CPU, the port's float32 squaring): the result
dicts must be equal, compared as JSON (the packages' ``Op`` values are
dicts of the same fields)."""

import json
import random

import pytest
import torch

from jepsen_etcd_tpu.checkers.elle.append import \
    ListAppendChecker as RefAppend
from jepsen_etcd_tpu.checkers.elle.graph import DepGraph as RefDepGraph
from jepsen_etcd_tpu.checkers.elle.wr import RWRegisterChecker as RefWR
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu_torch.checkers.elle import (ListAppendChecker,
                                                 RWRegisterChecker)
from jepsen_etcd_tpu_torch.checkers.elle.graph import DepGraph
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.ops import closure
from jepsen_etcd_tpu_torch.testing import gen_append_history, gen_wr_history

from test_torch_fixtures import one_torch_thread  # noqa: F401


def inv(p, txn):
    return {"type": "invoke", "process": p, "f": "txn", "value": txn}


def ok(p, txn):
    return {"type": "ok", "process": p, "f": "txn", "value": txn}


def fail(p, txn):
    return {"type": "fail", "process": p, "f": "txn", "value": txn,
            "error": "didnt-succeed"}


def info(p, txn):
    return {"type": "info", "process": p, "f": "txn", "value": txn}


SER = ("serializable",)

#: the list-append inputs of tests/test_elle.py: name -> (ops, models)
APPEND_CASES = {
    "sequential_valid": [
        inv(0, [["append", "x", 1]]), ok(0, [["append", "x", 1]]),
        inv(0, [["r", "x", None]]), ok(0, [["r", "x", [1]]]),
        inv(1, [["append", "x", 2]]), ok(1, [["append", "x", 2]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", [1, 2]]])],
    "g1c": [
        inv(0, [["append", "x", 1], ["r", "y", None]]),
        inv(1, [["append", "y", 1], ["r", "x", None]]),
        ok(0, [["append", "x", 1], ["r", "y", [1]]]),
        ok(1, [["append", "y", 1], ["r", "x", [1]]])],
    "g_single_read_skew": [
        inv(0, [["r", "x", None], ["r", "y", None]]),
        inv(1, [["append", "x", 1], ["append", "y", 1]]),
        ok(1, [["append", "x", 1], ["append", "y", 1]]),
        ok(0, [["r", "x", []], ["r", "y", [1]]]),
        inv(2, [["r", "x", None]]), ok(2, [["r", "x", [1]]])],
    "g0": [
        inv(0, [["append", "x", 1], ["append", "y", 2]]),
        inv(1, [["append", "x", 2], ["append", "y", 1]]),
        ok(0, [["append", "x", 1], ["append", "y", 2]]),
        ok(1, [["append", "x", 2], ["append", "y", 1]]),
        inv(2, [["r", "x", None], ["r", "y", None]]),
        ok(2, [["r", "x", [1, 2]], ["r", "y", [1, 2]]])],
    "stale_read_realtime": [
        inv(0, [["append", "x", 1]]), ok(0, [["append", "x", 1]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", []]]),
        inv(2, [["r", "x", None]]), ok(2, [["r", "x", [1]]])],
    "g1a": [
        inv(0, [["append", "x", 1]]), fail(0, [["append", "x", 1]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", [1]]])],
    "g1b": [
        inv(0, [["append", "x", 1], ["append", "x", 2]]),
        ok(0, [["append", "x", 1], ["append", "x", 2]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", [1]]])],
    "internal": [
        inv(0, [["append", "x", 1], ["r", "x", None]]),
        ok(0, [["append", "x", 1], ["r", "x", []]])],
    "own_reads_ok": [
        inv(0, [["append", "x", 1], ["r", "x", None]]),
        ok(0, [["append", "x", 1], ["r", "x", [1]]])],
    "incompatible_order": [
        inv(0, [["r", "x", None]]), ok(0, [["r", "x", [1, 2]]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", [2, 1]]])],
    "duplicate_elements": [
        inv(0, [["r", "x", None]]), ok(0, [["r", "x", [1, 1]]])],
    "info_txn_observed": [
        inv(0, [["append", "x", 1]]), info(0, [["append", "x", 1]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", [1]]])],
    "coexisting_g0_g1c": [
        inv(0, [["append", "x", 1], ["append", "y", 2]]),
        inv(1, [["append", "x", 2], ["append", "y", 1]]),
        ok(0, [["append", "x", 1], ["append", "y", 2]]),
        ok(1, [["append", "x", 2], ["append", "y", 1]]),
        inv(2, [["r", "x", None], ["r", "y", None]]),
        ok(2, [["r", "x", [1, 2]], ["r", "y", [1, 2]]]),
        inv(3, [["append", "p", 1], ["r", "q", None]]),
        inv(4, [["append", "q", 1], ["r", "p", None]]),
        ok(3, [["append", "p", 1], ["r", "q", [1]]]),
        ok(4, [["append", "q", 1], ["r", "p", [1]]])],
    "two_independent_g1c": [
        inv(0, [["append", "x", 1], ["r", "y", None]]),
        inv(1, [["append", "y", 1], ["r", "x", None]]),
        ok(0, [["append", "x", 1], ["r", "y", [1]]]),
        ok(1, [["append", "y", 1], ["r", "x", [1]]]),
        inv(2, [["append", "p", 1], ["r", "q", None]]),
        inv(3, [["append", "q", 1], ["r", "p", None]]),
        ok(2, [["append", "p", 1], ["r", "q", [1]]]),
        ok(3, [["append", "q", 1], ["r", "p", [1]]])],
}

#: the rw-register inputs of tests/test_elle.py
WR_CASES = {
    "sequential_valid": [
        inv(0, [["w", "x", 1]]), ok(0, [["w", "x", 1]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", 1]])],
    "internal": [
        inv(0, [["w", "x", 1], ["r", "x", None]]),
        ok(0, [["w", "x", 1], ["r", "x", 2]])],
    "g1a": [
        inv(0, [["w", "x", 1]]), fail(0, [["w", "x", 1]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", 1]])],
    "g1c": [
        inv(0, [["w", "x", 1], ["r", "y", None]]),
        inv(1, [["w", "y", 2], ["r", "x", None]]),
        ok(0, [["w", "x", 1], ["r", "y", 2]]),
        ok(1, [["w", "y", 2], ["r", "x", 1]])],
    "stale_read_realtime": [
        inv(0, [["w", "x", 1]]), ok(0, [["w", "x", 1]]),
        inv(1, [["r", "x", None]]), ok(1, [["r", "x", None]])],
    "cyclic_version_order": [
        inv(0, [["r", "x", None], ["w", "x", 2]]),
        ok(0, [["r", "x", 1], ["w", "x", 2]]),
        inv(1, [["r", "x", None], ["w", "x", 1]]),
        ok(1, [["r", "x", 2], ["w", "x", 1]])],
    "wfr_inference": [
        inv(0, [["w", "x", 1]]), ok(0, [["w", "x", 1]]),
        inv(1, [["r", "x", None], ["w", "x", 2]]),
        ok(1, [["r", "x", 1], ["w", "x", 2]]),
        inv(2, [["r", "x", None], ["r", "x", None]]),
        ok(2, [["r", "x", 2], ["r", "x", 1]])],
}

#: the cases tests/test_elle.py also checks under plain serializability
SERIALIZABLE_TOO = {("append", "stale_read_realtime"),
                    ("wr", "stale_read_realtime")}

CHECKERS = {"append": (RefAppend, ListAppendChecker),
            "wr": (RefWR, RWRegisterChecker)}


def as_json(x) -> str:
    return json.dumps(x, sort_keys=True)


def both(kind: str, ops: list, use_tpu=None, models=None) -> tuple:
    """(reference dict, port dict) of one history, the port's closure on
    the CPU."""
    ref_cls, port_cls = CHECKERS[kind]
    kw = {} if models is None else {"consistency_models": models}
    want = ref_cls(use_tpu=use_tpu, **kw).check(
        {}, RefHistory([RefOp(dict(o)) for o in ops]))
    got = port_cls(use_tpu=use_tpu, device="cpu", **kw).check(
        {}, History([Op(dict(o)) for o in ops]))
    return want, got


CASES = [("append", name) for name in APPEND_CASES] + \
    [("wr", name) for name in WR_CASES]


@pytest.mark.parametrize("use_tpu", [None, True])
@pytest.mark.parametrize("kind,name", CASES)
def test_reference_inputs_give_equal_dicts(kind, name, use_tpu):
    ops = (APPEND_CASES if kind == "append" else WR_CASES)[name]
    for models in [None] + ([SER] if (kind, name) in SERIALIZABLE_TOO
                            else []):
        want, got = both(kind, ops, use_tpu, models)
        assert as_json(got) == as_json(want)


def test_reference_verdicts_hold_on_the_port():
    """A few of tests/test_elle.py's own assertions, on the port."""
    def check(kind, name, models=None):
        return both(kind, (APPEND_CASES if kind == "append"
                           else WR_CASES)[name], True, models)[1]
    assert check("append", "sequential_valid")["valid?"] is True
    assert "G1c" in check("append", "g1c")["anomaly-types"]
    assert "G0" in check("append", "g0")["anomaly-types"]
    assert "G-single" in check("append", "g_single_read_skew")[
        "anomaly-types"]
    stale = check("append", "stale_read_realtime")
    assert stale["anomaly-types"] == ["G-single-realtime"]
    assert check("append", "stale_read_realtime", SER)["valid?"] is True
    assert len(check("append", "two_independent_g1c")["anomalies"][
        "G1c"]) == 2
    assert check("append", "info_txn_observed")["committed-count"] == 2
    assert "cyclic-version-order" in check("wr", "cyclic_version_order")[
        "anomaly-types"]


@pytest.mark.parametrize("force", [None, True])
def test_gsingle_and_g2item_both_reported(force):
    graphs = []
    for cls in (RefDepGraph, DepGraph):
        g = cls(4)
        g.add("rw", 0, 1)
        g.add("wr", 1, 0)
        g.add("rw", 2, 3)
        g.add("rw", 3, 2)
        graphs.append(g)
    want = graphs[0].find_cycles(realtime=False, force_device=force)
    got = graphs[1].find_cycles(realtime=False, force_device=force,
                                device="cpu")
    assert as_json(got) == as_json(want)
    assert {r["type"] for r in got} == {"G-single", "G2-item"}


GENERATORS = {"append": gen_append_history, "wr": gen_wr_history}


@pytest.mark.parametrize("corrupt", [None, "G-single-realtime", "G1c"])
@pytest.mark.parametrize("kind", ["append", "wr"])
def test_synthesized_histories_give_equal_dicts(kind, corrupt):
    h = GENERATORS[kind](random.Random(11), 10, 200, corrupt=corrupt)
    ops = [dict(o) for o in h]
    want, got = both(kind, ops, use_tpu=True)
    assert as_json(got) == as_json(want)
    assert got["committed-count"] == 200
    if corrupt is None:
        assert got["valid?"] is True
    else:
        assert got["valid?"] is False and corrupt in got["anomaly-types"]


@pytest.mark.parametrize("kind", ["append", "wr"])
def test_above_the_cutoff_both_take_the_device_route(monkeypatch, kind):
    """About 800 committed txns: with use_tpu unset both packages route
    the closure to the device (the port's float32 squaring here)."""
    n = 800
    assert n >= closure.CPU_CUTOFF
    h = GENERATORS[kind](random.Random(5), 10, n,
                         corrupt="G-single-realtime")
    routes = []
    inner = closure._closure_device

    def spy(a, iters, lanes=None):
        routes.append(tuple(a.shape))
        return inner(a, iters, lanes)
    monkeypatch.setattr(closure, "_closure_device", spy)
    want, got = both(kind, [dict(o) for o in h])
    assert routes == [(6, 1024, 1024)]
    assert as_json(got) == as_json(want)
    assert got["valid?"] is False
    assert "G-single-realtime" in got["anomaly-types"]


def test_checker_needs_a_card_above_the_cutoff(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = gen_append_history(random.Random(1), 10, closure.CPU_CUTOFF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ListAppendChecker().check({}, h)
    small = gen_wr_history(random.Random(1), 5, 50)
    assert RWRegisterChecker().check({}, small)["valid?"] is True
