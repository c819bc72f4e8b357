"""The port's batched columnar packer against the JAX reference:
``pack_register_histories_batched`` and ``_pack_reference`` give
``Packed`` bit-identical to the reference's on every field, frames
included, on the shapes of ``tests/test_wgl_batch_pack.py`` (info rates
0, 0.05 and 0.25; empty, invoke-only and one-read keys; corrupted keys;
keys the fast path delegates), and ``pack_register_history`` routes
through the batched packer as the reference's does. ``OpColumns``
(``columns_of``, ``split_by_key``) equals the reference's column for
column, and ``pack_perop_batch`` with padding keys equals the
reference's. The numpy extraction of column-backed keys gives the
per-op loop's columns row for row and leaves it every key it is not
sure of. Exact equality (tolerance 0)."""

import copy
import random

import numpy as np
import pytest

from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.history import columns_of as ref_columns_of
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.ops import wgl_mxu as ref_mxu
from jepsen_etcd_tpu_torch.core.history import History, columns_of
from jepsen_etcd_tpu_torch.generators import independent
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.runner import telemetry

from test_batch import keyed
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_pack import assert_packed_equal
from test_wgl import gen_history


def port_history(h) -> History:
    return History.from_jsonl(h.to_jsonl())


def gen_multi_key(rng, n_keys, info_rate=0.0, corrupt=False):
    """The reference test's key mix: {k: History} of small keys."""
    return {k: RefHistory(gen_history(
        rng, n_procs=rng.randint(2, 5), n_ops=rng.randint(6, 40),
        info_rate=info_rate, corrupt=corrupt)) for k in range(n_keys)}


def assert_packs_match(ref: dict, got: dict):
    """Every key's Packed equal, then equal again with frames built
    (which it builds on both sides)."""
    assert set(ref) == set(got)
    for k in ref:
        assert_packed_equal(ref[k], got[k])
        if ref[k].ok and got[k].ok:
            ref_wgl.ensure_frames(ref[k])
            wgl.ensure_frames(got[k])
            assert_packed_equal(ref[k], got[k])


def check_batched(subs: dict):
    """The port's batched packer and its per-key reference packer, on
    the port's copies of ``subs``, against the reference's batched
    packer and ``_pack_reference``."""
    port_subs = {k: port_history(h) for k, h in subs.items()}

    def per_key(pack, hs):
        return {k: pack(h) for k, h in hs.items()}

    ref_batched = ref_wgl.pack_register_histories_batched(subs)
    got_batched = wgl.pack_register_histories_batched(port_subs)
    assert list(ref_batched) == list(got_batched)
    assert_packs_match(ref_batched, got_batched)
    assert_packs_match(per_key(ref_wgl._pack_reference, subs),
                       wgl.pack_register_histories_batched(port_subs))
    assert_packs_match(per_key(ref_wgl._pack_reference, subs),
                       per_key(wgl._pack_reference, port_subs))
    return wgl.pack_register_histories_batched(port_subs)


@pytest.mark.parametrize("info_rate", [0.0, 0.05, 0.25])
def test_batched_packer_bit_identical(info_rate):
    rng = random.Random(int(info_rate * 100) + 5)
    got = check_batched(gen_multi_key(rng, 24, info_rate=info_rate))
    if info_rate:
        assert any(p.I for p in got.values())


def test_batched_packer_edge_keys():
    rng = random.Random(31)
    subs = gen_multi_key(rng, 6, info_rate=0.1)
    subs["empty"] = RefHistory([])
    subs["invoke-only"] = RefHistory([{"type": "invoke", "process": 0,
                                       "f": "write", "value": [None, 1]}])
    subs["one-read"] = RefHistory([
        {"type": "invoke", "process": 0, "f": "read",
         "value": [None, None]},
        {"type": "ok", "process": 0, "f": "read", "value": [None, None]},
    ])
    got = check_batched(subs)
    assert got["empty"].R == 0 and got["invoke-only"].R == 0


def test_batched_packer_corrupt_histories():
    check_batched(gen_multi_key(random.Random(77), 16, corrupt=True))


def _ops(*rows):
    out = []
    for t, p, f, v in rows:
        out.append({"type": t, "process": p, "f": f, "value": v})
    return RefHistory(out)


def test_batched_packer_delegated_keys():
    """Keys the columnar path cannot express (non-int values, a
    version-asserting info op, a malformed read value) delegate to the
    per-key packer and come out exactly as the reference's, beside keys
    the fast path takes."""
    rng = random.Random(9)
    subs = gen_multi_key(rng, 4, info_rate=0.1)
    subs["strings"] = _ops(("invoke", 0, "write", [None, "a"]),
                           ("ok", 0, "write", [1, "a"]),
                           ("invoke", 1, "read", [None, None]),
                           ("ok", 1, "read", [1, "a"]))
    subs["info-version"] = _ops(("invoke", 0, "write", [None, 1]),
                                ("ok", 0, "write", [1, 1]),
                                ("invoke", 1, "write", [3, 2]),
                                ("invoke", 2, "read", [None, None]),
                                ("ok", 2, "read", [1, 1]))
    subs["bad-version"] = _ops(("invoke", 0, "write", [None, 1]),
                               ("ok", 0, "write", ["x", 1]))
    subs["unsupported-f"] = _ops(("invoke", 0, "txn", [None, 1]),
                                 ("ok", 0, "txn", [1, 1]))
    got = check_batched(subs)
    assert got["strings"].ok and not got["bad-version"].ok
    assert not got["info-version"].ok and not got["unsupported-f"].ok


def test_pack_register_history_routes_through_the_batched_packer(
        monkeypatch):
    rng = random.Random(12)
    for k, h in gen_multi_key(rng, 6, info_rate=0.1).items():
        assert_packs_match({k: ref_wgl.pack_register_history(h)},
                           {k: wgl.pack_register_history(port_history(h))})
    calls = []
    real = wgl.pack_register_histories_batched
    monkeypatch.setattr(wgl, "pack_register_histories_batched",
                        lambda subs, **kw: calls.append(1) or real(subs))
    wgl.pack_register_history(port_history(h))
    assert calls == [1]


def timed_keyed(n_keys, seed, info_rate=0.0, corrupt_keys=()):
    """A keyed reference history whose ops carry ``time`` (so it has
    columns) and the port's copy of it, both column-backed."""
    rng = random.Random(seed)
    ops = []
    for k in range(n_keys):
        ops += keyed(gen_history(rng, n_procs=rng.randint(2, 4),
                                 n_ops=rng.randint(6, 30),
                                 info_rate=info_rate,
                                 corrupt=k in corrupt_keys),
                     f"k{k}" if k % 2 else k, 10 * k)
    ops = [op.evolve(time=1000 * t) for t, op in enumerate(ops)]
    ref = RefHistory(ops)
    ref = RefHistory(ref.ops, columns=ref_columns_of(ref.ops))
    port = port_history(ref)
    port = History(port.ops, columns=columns_of(port.ops))
    return ref, port


def assert_columns_equal(ref, got):
    for name in ("type_code", "f_code", "proc", "key_id", "time", "index"):
        a, b = getattr(ref, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("values", "extras", "missing", "f_table", "key_table",
                 "proc_table"):
        assert getattr(ref, name) == getattr(got, name), name


def test_columns_and_split_by_key_equal_the_reference():
    ref, port = timed_keyed(7, seed=4, info_rate=0.2, corrupt_keys=(2,))
    assert port.columns is not None
    assert_columns_equal(ref.columns, port.columns)
    assert port.columns.client_pairs() == ref.columns.client_pairs()
    ref_split = ref.columns.split_by_key()
    got_split = port.columns.split_by_key()
    assert list(ref_split) == list(got_split)
    for k in ref_split:
        assert_columns_equal(ref_split[k], got_split[k])
    # History.split_by_key: columnar when columns exist, the dict split
    # otherwise, both equal to the reference's per-key ops
    before = History.dict_materializations
    col_subs = port.split_by_key()
    assert History.dict_materializations == before
    dict_subs = History(port.ops).split_by_key()
    assert list(col_subs) == list(dict_subs) == \
        independent.history_keys(port)
    for k, sub in ref.split_by_key().items():
        assert col_subs[k].ops == dict_subs[k].ops == sub.ops
        assert dict_subs[k].ops == independent.subhistory(port, k)
        assert col_subs[k].pairs == sub.pairs


def test_column_backed_keys_pack_like_the_reference():
    """The batched packer's columnar front end (``_rows_from_columns``)
    packs split columns exactly as the reference does, and as the dict
    front end does."""
    ref, port = timed_keyed(9, seed=6, info_rate=0.15, corrupt_keys=(4,))
    before = History.dict_materializations
    got = wgl.pack_register_histories_batched(port.split_by_key())
    assert History.dict_materializations == before
    assert_packs_match(
        ref_wgl.pack_register_histories_batched(ref.split_by_key()), got)
    assert_packs_match(
        wgl.pack_register_histories_batched(port.split_by_key()),
        wgl.pack_register_histories_batched(
            History(port.ops).split_by_key()))


def test_pack_perop_batch_with_padding_keys():
    rng = random.Random(13)
    packs = []
    for _ in range(40):
        p = ref_wgl.pack_register_history(RefHistory(gen_history(
            rng, n_procs=rng.randint(2, 4), n_ops=rng.randint(6, 40))))
        if p.ok and ref_mxu.supported(p):
            packs.append(p)
    assert len(packs) >= 20
    groups = {}
    for p in packs:
        groups.setdefault((max(ref_wgl.bucket(p.R), ref_mxu.TSUB), p.w),
                          []).append(p)
    for (r_pad, _), chunk in groups.items():
        k_pad = len(chunk) + 3
        ports = [wgl.Packed.from_numpy(vars(p)) for p in chunk]
        for a, b in zip(ref_mxu.pack_perop_batch(chunk, r_pad, k_pad),
                        wgl_mxu.pack_perop_batch(ports, r_pad, k_pad)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
            assert not b[len(chunk):].any()
        for j, p in enumerate(ports):
            single = wgl_mxu.pack_perop(p, r_pad)
            got = wgl_mxu.pack_perop_batch(ports, r_pad, k_pad)
            assert np.array_equal(got[0][j], single[0])
            assert np.array_equal(got[1][j], single[1])


def test_pack_perop_batch_empty():
    bi, bu = wgl_mxu.pack_perop_batch([], 128, 4)
    assert bi.shape == (4, 128, 4) and not bi.any() and not bu.any()


# -- the vectorized extraction of column-backed keys -------------------------

def key_rows(h) -> list:
    """A generated history's ops as (type, process, f, value) rows."""
    return [(op["type"], op["process"], op["f"], op["value"]) for op in h]


def regular_keys(rng, n, info_rate=0.0, first=0) -> dict:
    return {k: key_rows(gen_history(rng, n_procs=rng.randint(2, 5),
                                    n_ops=rng.randint(6, 40),
                                    info_rate=info_rate))
            for k in range(first, first + n)}


def tupled(x):
    return tuple(tupled(y) for y in x) if isinstance(x, list) else x


def column_backed(per_key: dict):
    """``{key: rows}`` as one keyed history, the keys' rows interleaved
    round robin, each op's ``time`` and ``index`` its position; returns
    the reference's and the port's per-key split of it (column-backed
    wherever the ops fit the column schema)."""
    ops, queues = [], [list(rows) for rows in per_key.values()]
    while any(queues):
        for k, q in zip(per_key, queues):
            if q:
                t, p, f, v = q.pop(0)
                ops.append({"type": t, "process": p, "f": f,
                            "value": (k, v), "time": 1000 * len(ops),
                            "index": len(ops)})
    ref_ops, port_ops = copy.deepcopy(ops), copy.deepcopy(ops)
    ref = RefHistory(ref_ops, columns=ref_columns_of(ref_ops))
    port = History(port_ops, columns=columns_of(port_ops))
    return ref.split_by_key(), port.split_by_key()


def loop_extract(cols):
    """The extraction loop over a key's columns: (n_req, lists, ilists),
    n_req None where the loop raises (the key then delegates)."""
    lists = tuple([] for _ in range(8))
    ilists = tuple([] for _ in range(6))
    try:
        n_req = wgl._extract_key_columns(wgl._rows_from_columns(cols),
                                         lists, ilists)
    except (wgl._Delegate, TypeError, ValueError):
        return None, lists, ilists
    return n_req, lists, ilists


def packed_with_counter(subs: dict):
    """The batched pack of ``subs`` and its ``wgl.pack-columnar`` count."""
    tel = telemetry.Telemetry()
    telemetry.set_current(tel)
    try:
        out = wgl.pack_register_histories_batched(subs)
    finally:
        telemetry.set_current(None)
    return out, tel.summary()["counters"].get("wgl.pack-columnar", 0)


def ok_write(p, v, ver=1):
    return [("invoke", p, "write", [None, v]), ("ok", p, "write", [ver, v])]


def ok_read(p, v, ver=1):
    return [("invoke", p, "read", [None, None]), ("ok", p, "read", [ver, v])]


def columnar_case(name: str):
    """``(per_key, loop_keys)``: the case's keys, and those the
    vectorized extraction must leave to the loop (every other key it
    must take)."""
    rng = random.Random(name)
    if name.startswith("info rate "):
        return regular_keys(rng, 10, float(name[10:])), set()
    if name == "tuple payloads":
        keys = regular_keys(rng, 8, 0.2)
        for k in (1, 3, 5, 7):            # tuples in some keys, not all
            keys[k] = [(t, p, f, tupled(v)) for t, p, f, v in keys[k]]
        keys["mixed"] = ok_write(0, 1) + [
            ("invoke", 1, "read", (None, None)), ("ok", 1, "read", (1, 1)),
            ("invoke", 2, "cas", [None, (1, 2)]),
            ("ok", 2, "cas", (2, [1, 2]))]
        return keys, set()
    if name == "bool values":
        return {**regular_keys(rng, 3),
                "write": ok_write(0, True) + ok_read(1, True),
                "version": ok_write(0, 1, ver=True),
                "cas": ok_write(0, 1) + [
                    ("invoke", 1, "cas", [None, [1, False]]),
                    ("ok", 1, "cas", [2, [1, False]])],
                "info": ok_write(0, 1) + [
                    ("invoke", 1, "write", [None, True]),
                    ("info", 1, "write", [None, True])]}, \
            {"write", "version", "cas", "info"}
    if name == "versions at 2**29":
        top, low = 2 ** 29 - 1, -(2 ** 29) + 1
        return {"top": ok_write(0, 1, ver=top) + ok_read(1, 1, ver=top),
                "low": ok_write(0, 2, ver=low) + ok_read(1, 2, ver=low),
                "over": ok_write(0, 1, ver=2 ** 29),
                "under": ok_write(0, 1, ver=-(2 ** 29)),
                "no-assert": ok_write(0, 1, ver=None) + ok_read(1, 1,
                                                                 ver=None),
                **regular_keys(rng, 2)}, {"over", "under"}
    if name == "non-int payloads":
        return {**regular_keys(rng, 3),
                "str": ok_write(0, "a") + ok_read(1, "a"),
                "float-version": ok_write(0, 1, ver=1.0),
                "numpy-int": ok_write(0, np.int64(3)),
                "cas-str": [("invoke", 0, "cas", [None, ["a", 1]]),
                            ("ok", 0, "cas", [1, ["a", 1]])],
                "cas-shape": [("invoke", 0, "cas", [None, "ab"]),
                              ("ok", 0, "cas", [1, "ab"])],
                "info-str": ok_write(0, 1) + [
                    ("invoke", 1, "cas", [None, [1, "b"]]),
                    ("info", 1, "cas", [None, [1, "b"]])],
                "info-version": ok_write(0, 1) + [
                    ("invoke", 1, "write", [3, 2]),
                    ("info", 1, "write", [3, 2])]}, \
            {"str", "float-version", "numpy-int", "cas-str", "cas-shape",
             "info-str", "info-version"}
    if name == "3-element payloads":
        return {**regular_keys(rng, 2),
                "write": [("invoke", 0, "write", [None, 1]),
                          ("ok", 0, "write", [1, 1, 1])],
                "cas": [("invoke", 0, "cas", [None, [0, 1]]),
                        ("ok", 0, "cas", [1, [0, 1, 2]])],
                "read": ok_write(0, 1) + [
                    ("invoke", 1, "read", [None, None]),
                    ("ok", 1, "read", [1])],
                "info": ok_write(0, 1) + [
                    ("invoke", 1, "write", [None, 2, 3]),
                    ("info", 1, "write", [None, 2, 3])]}, \
            {"write", "cas", "read", "info"}
    if name == "ad-hoc op types":
        # an op type the column schema has no code for: the history
        # stays dict-backed and every key takes the loop
        keys = regular_keys(rng, 3)
        keys["sleep"] = ok_write(0, 1) + [("sleep", 1, "write", None)] \
            + ok_read(1, 1)
        return keys, set(keys)
    if name == "double invokes":
        return {**regular_keys(rng, 3),
                "twice": [("invoke", 0, "write", [None, 1]),
                          ("invoke", 0, "write", [None, 2]),
                          ("ok", 0, "write", [1, 2])] + ok_read(1, 2),
                "open-twice": ok_write(0, 1) + [
                    ("invoke", 1, "write", [None, 2]),
                    ("invoke", 1, "cas", [None, [2, 3]])]}, \
            {"twice", "open-twice"}
    if name == "completion with no invoke":
        return {**regular_keys(rng, 3),
                "orphan": [("ok", 0, "read", [0, None])] + ok_write(0, 1),
                "orphan-info": ok_write(0, 1) + [
                    ("info", 1, "write", [None, 2])] + ok_read(1, 1)}, \
            {"orphan", "orphan-info"}
    if name == "nemesis processes":
        keys = regular_keys(rng, 4, 0.1)
        for rows in keys.values():
            at = len(rows) // 2
            rows[at:at] = [("info", "nemesis", "kill", None),
                           ("invoke", "nemesis", "partition", ["n1"]),
                           ("info", "nemesis", "partition", "done")]
        return keys, set()
    if name == "info reads":
        return {**regular_keys(rng, 2),
                "reads": ok_write(0, 1) + [
                    ("invoke", 1, "read", [None, None]),
                    ("info", 1, "read", ["anything", "at all"]),
                    ("invoke", 2, "read", [None, None]),
                    ("info", 2, "read", None)] + ok_read(3, 1)}, set()
    if name == "open at the end":
        open_ops = [("invoke", 4, "cas", [None, [1, 2]]),
                    ("invoke", 2, "write", [None, 3]),
                    ("invoke", 3, "read", [None, None]),
                    ("invoke", 5, "write", None),
                    ("invoke", 6, "write", [None, None])]
        keys = regular_keys(rng, 3, 0.2)
        for rows in keys.values():
            rows += open_ops
        keys["open"] = ok_write(0, 1) + open_ops[:2] + ok_read(1, 1) \
            + [("invoke", 7, "write", [None, 4]),
               ("info", 7, "write", [None, 4])] + open_ops[2:]
        return keys, set()
    if name == "mixed batch":
        keys = regular_keys(rng, 6, 0.1)
        keys.update(regular_keys(rng, 2, 0.0, first=100))
        keys["str"] = ok_write(0, "a") + ok_read(1, "a")
        keys["twice"] = [("invoke", 0, "write", [None, 1]),
                         ("invoke", 0, "write", [None, 2]),
                         ("ok", 0, "write", [1, 2])]
        keys["no-ok"] = [("invoke", 0, "write", [None, 1]),
                         ("info", 0, "write", [None, 1]),
                         ("invoke", 1, "read", [None, None]),
                         ("fail", 1, "read", [None, None]),
                         ("invoke", 2, "txn", [None, 1]),
                         ("fail", 2, "txn", [None, 1])]
        keys["empty-values"] = ok_read(0, None, ver=0)
        keys["bool-process"] = ok_write(True, 1) + ok_read(1, 1)
        keys["negative-process"] = ok_write(-3, 1) + ok_read(1, 1)
        keys["info-txn"] = ok_write(0, 1) + [("invoke", 1, "txn", [None, 1]),
                                             ("info", 1, "txn", [None, 1])]
        keys["open-txn"] = ok_write(0, 1) + [("invoke", 1, "txn",
                                              [None, 1])]
        keys["open-cas-none"] = ok_write(0, 1) + [("invoke", 1, "cas",
                                                   None)]
        return keys, {"str", "twice", "bool-process", "negative-process",
                      "info-txn", "open-txn", "open-cas-none"}
    raise ValueError(name)


COLUMNAR_CASES = ["info rate 0", "info rate 0.05", "info rate 0.25",
                  "tuple payloads",
                  "bool values", "versions at 2**29", "non-int payloads",
                  "3-element payloads", "ad-hoc op types", "double invokes",
                  "completion with no invoke", "nemesis processes",
                  "info reads", "open at the end", "mixed batch"]


@pytest.mark.parametrize("name", COLUMNAR_CASES)
def test_columnar_extraction_equals_the_loop_and_the_reference(name):
    """The vectorized extraction of column-backed keys gives the loop's
    columns exactly, row for row, on every key it takes, and leaves to
    the loop every key it is not sure of; the batched packer over the
    keys then gives the reference's ``Packed`` bit for bit, in the
    reference's key order, and counts the keys it took."""
    per_key, loop_keys = columnar_case(name)
    ref_subs, port_subs = column_backed(per_key)
    assert list(port_subs) == list(per_key)
    items = [(k, h.columns) for k, h in port_subs.items()
             if h.columns is not None]
    for k, cols in items:
        taken, got = wgl._columnar_keys([(k, cols)])
        n_req, lists, ilists = loop_extract(cols)
        assert bool(taken) == (k not in loop_keys), k
        if taken:
            assert n_req is not None, k
            assert got[0].tolist() == [n_req], k
            assert got[1].tolist() == [len(ilists[0])], k
            for want, col in zip(lists + ilists, got[2:]):
                assert col.tolist() == want, k
    # all at once: the keys taken one by one, their columns concatenated
    taken, got = wgl._columnar_keys(items) if items else ([], None)
    assert taken == [k for k, _ in items if k not in loop_keys]
    if taken:
        alone = [wgl._columnar_keys([(k, c)])[1] for k, c in items
                 if k in taken]
        for j, col in enumerate(got):
            assert col.tolist() == np.concatenate(
                [a[j] for a in alone]).tolist()
    # where a key makes the reference raise, the port raises the same
    try:
        want = ref_wgl.pack_register_histories_batched(ref_subs)
    except (TypeError, ValueError) as e:
        want = e
    try:
        out, counted = packed_with_counter(port_subs)
    except (TypeError, ValueError) as e:
        assert (type(e), str(e)) == (type(want), str(want))
        return
    assert counted == len(taken)
    assert list(want) == list(out)
    assert_packs_match(want, out)


def test_columnar_extraction_past_int64_raises_as_the_loop_does():
    """A value past int64 goes to the loop, whose tail raises the
    reference's OverflowError."""
    per_key = {0: ok_write(0, 2 ** 70) + ok_read(1, 2 ** 70),
               **regular_keys(random.Random(3), 2, first=1)}
    ref_subs, port_subs = column_backed(per_key)
    assert wgl._columnar_keys([(0, port_subs[0].columns)]) == ([], None)
    with pytest.raises(OverflowError):
        ref_wgl.pack_register_histories_batched(ref_subs)
    with pytest.raises(OverflowError):
        wgl.pack_register_histories_batched(port_subs)


@pytest.mark.parametrize("backing", ["columns", "dicts", "loop keys"])
def test_pack_columnar_counts_the_keys_the_extraction_took(backing):
    """``wgl.pack-columnar`` counts every key of a column-backed batch,
    nothing for a dict-backed history, and nothing for a key the loop
    took."""
    per_key = regular_keys(random.Random(backing), 7, 0.1)
    if backing == "loop keys":
        per_key["twice"] = [("invoke", 0, "write", [None, 1]),
                            ("invoke", 0, "write", [None, 2]),
                            ("ok", 0, "write", [1, 2])]
        per_key["str"] = ok_write(0, "a")
    _, subs = column_backed(per_key)
    if backing == "dicts":
        subs = {k: History(h.ops) for k, h in subs.items()}
    out, counted = packed_with_counter(subs)
    assert counted == {"columns": 7, "dicts": 0, "loop keys": 7}[backing]
    assert len(out) == len(per_key)
