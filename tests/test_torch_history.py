"""Twin of the reference's ``tests/test_history.py`` on the port's
``core/`` (``core/history.py`` differs from the reference's in its
docstrings and the place of ``client_ops``): each test runs on both
packages (``both``) and what it observes (ops, pairs, indices, JSONL
bytes, raised errors) is equal."""

import pytest

from test_torch_fixtures import both, mod, one_torch_thread  # noqa: F401


def core(pkg):
    return mod(pkg, "core")


def _op_attribute_access(pkg):
    c = core(pkg)
    op = c.invoke_op(0, "read")
    assert op.type == "invoke"
    assert op.f == "read"
    assert op.value is None
    assert op.error is None
    assert op.is_invoke and not op.is_ok
    return dict(op)


def test_op_attribute_access():
    both(_op_attribute_access)


def _op_completions(pkg):
    c = core(pkg)
    op = c.invoke_op(3, "write", 5)
    done = c.ok(op, value=5)
    assert done.is_ok and done.process == 3 and done.value == 5
    assert op.is_invoke
    f = c.fail(op, error="cas-failed")
    assert f.is_fail and f.error == "cas-failed"
    i = c.info(op, error="timeout")
    assert i.is_info
    assert i.is_client_op
    return [dict(x) for x in (op, done, f, i)]


def test_op_completions():
    both(_op_completions)


def _pairing(pkg):
    c = core(pkg)
    h = c.History([
        c.invoke_op(0, "read"),
        c.invoke_op(1, "write", 1),
        c.Op(type="ok", f="write", value=1, process=1),
        c.Op(type="ok", f="read", value=1, process=0),
    ])
    assert h.pairs == {0: 3, 1: 2, 2: 1, 3: 0}
    assert h.completion(h[0])["index"] == 3
    assert h.invocation(h[2])["index"] == 1
    return h.pairs, h.to_jsonl(), c.pair_index(h.ops)


def test_pairing():
    both(_pairing)


def _pairing_unmatched_invoke(pkg):
    c = core(pkg)
    h = c.History([
        c.invoke_op(0, "read"),
        c.Op(type="info", f="write", value=None, process=1),
    ])
    assert h.pairs[0] is None
    assert h.pairs[1] is None
    return h.pairs


def test_pairing_unmatched_invoke():
    both(_pairing_unmatched_invoke)


def _double_invoke_raises(pkg):
    c = core(pkg)
    h = c.History([c.invoke_op(0, "read"), c.invoke_op(0, "read")])
    with pytest.raises(ValueError) as e:
        _ = h.pairs
    return str(e.value)


def test_double_invoke_raises():
    both(_double_invoke_raises)


def _filters_and_roundtrip(pkg):
    c = core(pkg)
    h = c.History([
        c.invoke_op("nemesis", "kill", ["n1"]),
        c.invoke_op(0, "read"),
        c.Op(type="ok", f="read", value=7, process=0),
        c.Op(type="info", f="kill", value=["n1"], process="nemesis"),
    ])
    assert len(h.client_ops()) == 2
    assert len(h.nemesis_ops()) == 2
    assert len(h.oks()) == 1
    h2 = c.History.from_jsonl(h.to_jsonl())
    assert len(h2) == len(h)
    assert h2[2].value == 7
    assert h2.pairs
    return [x.to_jsonl() for x in (h, h.client_ops(), h.nemesis_ops(),
                                   h.oks(), h2)], h2.pairs


def test_filters_and_roundtrip():
    both(_filters_and_roundtrip)


def _filtered_history_pairing(pkg):
    c = core(pkg)
    h = c.History([
        c.invoke_op("nemesis", "kill"),
        c.Op(type="info", f="kill", process="nemesis"),
        c.invoke_op(0, "read"),
        c.Op(type="ok", f="read", value=3, process=0),
    ])
    sub = h.client_ops()
    inv = sub[0]
    assert inv["index"] == 2
    comp = sub.completion(inv)
    assert comp is not None and comp.value == 3
    return dict(comp), sub.pairs


def test_filtered_history_pairing():
    both(_filtered_history_pairing)


def _tuple_value_roundtrip(pkg):
    c = core(pkg)
    h = c.History([
        c.invoke_op(0, "txn", [("r", 5, None), ("append", 5, 1)]),
        c.Op(type="ok", f="read", value=("k", 1), process=0),
    ])
    h2 = c.History.from_jsonl(h.to_jsonl())
    assert h2[1].value == ("k", 1)
    assert h2[0].value == [("r", 5, None), ("append", 5, 1)]
    return h.to_jsonl(), h2.to_jsonl()


def test_tuple_value_roundtrip():
    both(_tuple_value_roundtrip)


def _dict_key_and_index_collision_fixes(pkg):
    c = core(pkg)
    h = c.History([c.Op(type="ok", f="read", process=0,
                        value={5: "a", ("k", 1): 2})])
    h2 = c.History.from_jsonl(h.to_jsonl())
    assert h2[0].value == {5: "a", ("k", 1): 2}
    h3 = c.History([c.Op(type="invoke", f="r", process=0, index=1),
                    c.Op(type="ok", f="r", process=0)])
    assert h3[1]["index"] == 2
    assert h3.pairs == {1: 2, 2: 1}
    with pytest.raises(ValueError) as e:
        c.History([c.Op(type="invoke", f="r", process=0, index=1),
                   c.Op(type="ok", f="r", process=0, index=1)])
    return h.to_jsonl(), h3.to_jsonl(), str(e.value)


def test_dict_key_and_index_collision_fixes():
    both(_dict_key_and_index_collision_fixes)
