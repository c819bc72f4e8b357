"""The Elle checkers on column-backed histories. ``collect_txns`` reads
a column-backed ``History``'s txns from its columns
(``graph._collect_txns_columns``), building an op only where a report
reads it; every txn, verdict, anomaly and certificate must equal what
the op-backed history of the same ops gives, which
tests/test_torch_elle.py holds to the JAX package's."""

import json
import random

import pytest

from jepsen_etcd_tpu_torch.checkers.elle import (ListAppendChecker,
                                                 RWRegisterChecker)
from jepsen_etcd_tpu_torch.checkers.elle import graph
from jepsen_etcd_tpu_torch.core.history import History, columns_of
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.testing import gen_append_history, gen_wr_history

from test_torch_elle import APPEND_CASES, WR_CASES
from test_torch_fixtures import one_torch_thread  # noqa: F401

CHECKERS = {"append": ListAppendChecker, "wr": RWRegisterChecker}
GENERATORS = {"append": gen_append_history, "wr": gen_wr_history}


def recorded(ops: list) -> list:
    """``ops`` as a recorded run has them: each with its position as
    ``index``, and a ``time``."""
    return [dict(o, index=i, time=o.get("time", 10 * i))
            for i, o in enumerate(ops)]


def with_nemesis(ops: list, rng: random.Random) -> list:
    """``ops`` with nemesis invoke/info pairs interleaved and one client
    invoke left open at the end."""
    out = []
    for o in ops:
        if rng.random() < 0.05:
            out.append({"type": "invoke", "process": "nemesis",
                        "f": "kill", "value": None})
            out.append({"type": "info", "process": "nemesis",
                        "f": "kill", "value": ["n1"]})
        out.append(dict(o))
    out.append({"type": "invoke", "process": 99, "f": "txn",
                "value": [["append", "x", 10 ** 6]]})
    return out


def both(kind: str, ops: list, monkeypatch) -> tuple:
    """(op-backed dict, column-backed dict) of one history on the host
    closure; the column-backed check must take the columns' path and
    build no history's ops."""
    ops = recorded(ops)
    cols = columns_of([Op(o) for o in ops])
    assert cols is not None
    calls = []
    inner = graph._collect_txns_columns

    def spy(c):
        calls.append(len(c))
        return inner(c)
    monkeypatch.setattr(graph, "_collect_txns_columns", spy)
    want = CHECKERS[kind](use_tpu=False).check(
        {}, History([Op(o) for o in ops]))
    assert calls == []
    before = History.dict_materializations
    got = CHECKERS[kind](use_tpu=False).check(
        {}, History.from_columns(cols))
    assert calls == [len(ops)]
    assert History.dict_materializations == before
    return want, got


def as_json(x) -> str:
    return json.dumps(x, sort_keys=True, default=repr)


CASES = [("append", n) for n in APPEND_CASES] + \
    [("wr", n) for n in WR_CASES]


@pytest.mark.parametrize("kind,name", CASES)
def test_reference_inputs_give_equal_dicts(kind, name, monkeypatch):
    ops = (APPEND_CASES if kind == "append" else WR_CASES)[name]
    want, got = both(kind, ops, monkeypatch)
    assert as_json(got) == as_json(want)


@pytest.mark.parametrize("corrupt", [None, "G-single-realtime", "G1c"])
@pytest.mark.parametrize("kind", ["append", "wr"])
def test_synthesized_histories_give_equal_dicts(kind, corrupt,
                                                monkeypatch):
    h = GENERATORS[kind](random.Random(13), 10, 300, corrupt=corrupt)
    ops = with_nemesis([dict(o) for o in h], random.Random(2))
    want, got = both(kind, ops, monkeypatch)
    assert as_json(got) == as_json(want)
    assert got["valid?"] is (corrupt is None)


def test_txns_read_from_columns_equal_the_ops():
    """Each txn's fields, and its completion op once read, equal the
    op path's: fail, info, an open invoke, nemesis rows between."""
    ops = recorded(with_nemesis(
        APPEND_CASES["info_txn_observed"] + APPEND_CASES["g1a"]
        + APPEND_CASES["internal"], random.Random(0)))
    by_ops = graph.collect_txns(History([Op(o) for o in ops]))
    by_cols = graph.collect_txns(
        History.from_columns(columns_of([Op(o) for o in ops])))
    assert len(by_cols) == len(by_ops) > 0
    for a, b in zip(by_cols, by_ops):
        assert (a.invoke_index, a.complete_index, a.mops, a.status) == \
            (b.invoke_index, b.complete_index, b.mops, b.status)
        assert a._op is None
        assert dict(a.op) == dict(b.op)
    assert {t.status for t in by_cols} == {"ok", "fail", "info"}


def test_a_process_invoking_twice_raises_on_both_paths():
    ops = recorded([
        {"type": "invoke", "process": 0, "f": "txn",
         "value": [["append", "x", 1]]},
        {"type": "invoke", "process": 0, "f": "txn",
         "value": [["append", "x", 2]]},
        {"type": "ok", "process": 0, "f": "txn",
         "value": [["append", "x", 2]]}])
    errors = []
    for h in (History([Op(o) for o in ops]),
              History.from_columns(columns_of([Op(o) for o in ops]))):
        with pytest.raises(ValueError) as e:
            graph.collect_txns(h)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_columns_the_ops_override_take_the_op_path():
    """An extra that overrides a core key, or a missing one, sends the
    history down the op path, whose txns are the ops'."""
    ops = recorded(APPEND_CASES["g1c"])
    cols = columns_of([Op(o) for o in ops])
    cols.missing[0] = ("time",)
    assert not graph._plain_columns(cols)
    cols = columns_of([Op(o) for o in ops])
    cols.extras[2] = {"value": [["append", "y", 7]]}
    assert not graph._plain_columns(cols)
    txns = graph.collect_txns(History.from_columns(cols))
    assert txns[0].mops == [["append", "y", 7]]
    assert graph._plain_columns(columns_of([Op(o) for o in ops]))
