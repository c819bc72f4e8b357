"""The port's set-full checker (``checkers/set_full.py``) and set
workload (``workloads/set.py``) against the reference's, on the shapes
of tests/test_set.py: the seven hand-written fixtures, the end-to-end
and serializable-stale runs, the columnar-against-reference fuzz and
the fall-back on non-int values. ``ColumnScan`` fed in chunks equals
the one-shot scan, and the epoch-v3 generator's set histories get the
reference's verdicts. Tolerance 0: the dicts are equal.
"""

import importlib
import json
import random

import numpy as np
import pytest

from jepsen_etcd_tpu import compose as ref_compose
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.runner import test_runner as ref_runner
from jepsen_etcd_tpu_torch import compose
from jepsen_etcd_tpu_torch.checkers.set_full import (ColumnScan, SetFull,
                                                     _NonColumnar,
                                                     _analyze_columnar,
                                                     _analyze_reference,
                                                     analyze)
from jepsen_etcd_tpu_torch.core.history import History, columns_of
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.runner import test_runner
from jepsen_etcd_tpu_torch.runner.stream import _slice_columns

from test_torch_fixtures import one_torch_thread  # noqa: F401

# the packages' ``checkers`` export a function named ``set_full`` too
sf = importlib.import_module("jepsen_etcd_tpu_torch.checkers.set_full")
ref_sf = importlib.import_module("jepsen_etcd_tpu.checkers.set_full")


def both(ops):
    """The same op dicts as a port and a reference History."""
    ops = [dict(o) for o in ops]
    return (History([Op(o) for o in ops]),
            RefHistory([RefOp(o) for o in ops]))


def indexed(ops):
    """The ops with the index and time a recorded history carries (the
    column schema needs both)."""
    return [dict(o, index=i, time=10 * i) for i, o in enumerate(ops)]


def add(p, x):
    return ({"type": "invoke", "process": p, "f": "add", "value": x},
            {"type": "ok", "process": p, "f": "add", "value": x})


def add_info(p, x):
    return ({"type": "invoke", "process": p, "f": "add", "value": x},
            {"type": "info", "process": p, "f": "add", "value": x})


def read(p, xs):
    return ({"type": "invoke", "process": p, "f": "read", "value": None},
            {"type": "ok", "process": p, "f": "read", "value": list(xs)})


def flat(*pairs):
    return [o for pair in pairs for o in pair]


#: tests/test_set.py:34-91, each with what the reference asserts of it
FIXTURES = {
    "stable": (flat(add(0, 1), add(0, 2), read(1, [1, 2]),
                    read(1, [1, 2])), True),
    "lost": (flat(add(0, 1), add(0, 2), read(1, [1, 2]), read(1, [1])),
             False),
    "stale": (flat(add(0, 1), add(0, 2), read(1, [1]), read(1, [1, 2])),
              False),
    "info-never-observed": (flat(add(0, 1), add_info(1, 9), read(2, [1]),
                                 read(2, [1])), True),
    "info-observed-then-lost": (flat(add(0, 1), add_info(1, 9),
                                     read(2, [1, 9]), read(2, [1])),
                                False),
    "never-read": (flat(read(1, []), add(0, 1)), "unknown"),
    "duplicate": (flat(add(0, 1), read(1, [1, 1])), False),
}


def _same_dict(got, want):
    assert json.dumps(got, sort_keys=True, default=repr) == \
        json.dumps(want, sort_keys=True, default=repr)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("linearizable", [True, False])
def test_fixture_dicts_equal_the_references(name, linearizable):
    ops, valid_lin = FIXTURES[name]
    h, rh = both(ops)
    got = SetFull(linearizable=linearizable).check({}, h)
    want = ref_sf.SetFull(linearizable=linearizable).check({}, rh)
    _same_dict(got, want)
    if linearizable:
        assert got["valid?"] == valid_lin
    assert _analyze_columnar(h) == _analyze_reference(h)


def test_fixture_shapes():
    """The reference's own assertions on the fixtures
    (tests/test_set.py:34-91), on the port."""
    def chk(name, lin=False):
        return SetFull(linearizable=lin).check({}, both(FIXTURES[name][0])[0])
    r = chk("stable", True)
    assert (r["stable-count"], r["lost-count"]) == (2, 0)
    assert chk("lost")["lost"] == [2]
    r = chk("stale")
    assert r["valid?"] is True and r["stale"] == [2]
    assert r["worst-stale"][0]["element"] == 2
    assert chk("info-never-observed", True)["unknown-count"] == 1
    assert chk("info-observed-then-lost")["lost"] == [9]
    assert chk("never-read", True)["never-read-count"] == 1
    only_add = SetFull(linearizable=True).check(
        {}, both(flat(add(0, 1)))[0])
    assert only_add["valid?"] == "unknown"
    assert chk("duplicate")["duplicated-count"] == 1


@pytest.mark.parametrize("opts", [
    {"time_limit": 6, "rate": 50, "seed": 11},
    {"time_limit": 8, "rate": 100, "serializable": True, "seed": 3},
], ids=["e2e", "serializable-stale"])
def test_set_workload_runs_equal_the_references(tmp_path, opts):
    """tests/test_set.py:93-110: the same history bytes and the same
    SetFull dict as the reference's run."""
    o = dict(opts, workload="set")
    port = test_runner.run_test(compose.etcd_test(
        dict(o, device="cpu", store_base=str(tmp_path / "p"))))
    ref = ref_runner.run_test(ref_compose.etcd_test(
        dict(o, store_base=str(tmp_path / "r"))))
    assert port["history"].to_jsonl() == ref["history"].to_jsonl()
    wl = port["results"]["workload"]
    _same_dict(wl, ref["results"]["workload"])
    assert wl["lost-count"] == 0
    if not opts.get("serializable"):
        assert port["valid?"] is True and wl["stable-count"] > 10


def gen_set_history(rng, n_ops=140, p_stale=0.0, p_dup=0.0, p_lose=0.0,
                    p_shuffle=0.0, p_info=0.08):
    """tests/test_set.py:131-183's concurrent set history as op dicts:
    adds and snapshot reads over 6 processes, with stale snapshot
    reads, duplicated elements, silent loss and shuffled views."""
    ops, store, snaps = [], [], [[]]
    pend, nxt = {}, 0
    for _ in range(n_ops):
        p = rng.randrange(6)
        if p in pend:
            kind, x = pend.pop(p)
            if kind == "add":
                r = rng.random()
                if r < p_info:
                    ops.append(dict(type="info", process=p, f="add",
                                    value=x, error="timeout"))
                    if rng.random() < 0.5:
                        store.append(x)
                        snaps.append(sorted(store))
                elif r < p_info + 0.06:
                    ops.append(dict(type="fail", process=p, f="add",
                                    value=x))
                else:
                    ops.append(dict(type="ok", process=p, f="add",
                                    value=x))
                    store.append(x)
                    if p_lose and store and rng.random() < p_lose:
                        store.pop(rng.randrange(len(store)))
                    snaps.append(sorted(store))
            else:
                view = list(snaps[-1])
                if p_stale and len(snaps) > 1 and rng.random() < p_stale:
                    view = list(snaps[rng.randrange(len(snaps))])
                if p_dup and view and rng.random() < p_dup:
                    view.append(view[rng.randrange(len(view))])
                if p_shuffle and rng.random() < p_shuffle:
                    rng.shuffle(view)
                ops.append(dict(type="ok", process=p, f="read",
                                value=view))
        elif rng.random() < 0.55:
            x = nxt
            nxt += 1
            ops.append(dict(type="invoke", process=p, f="add", value=x))
            pend[p] = ("add", x)
        else:
            ops.append(dict(type="invoke", process=p, f="read",
                            value=None))
            pend[p] = ("read", None)
    for p, (kind, x) in pend.items():
        ops.append(dict(type="info", process=p, f=kind, value=x,
                        error="never-returned"))
    return ops


#: tests/test_set.py:186-193
FUZZ = [dict(), dict(p_stale=0.2), dict(p_dup=0.15), dict(p_lose=0.1),
        dict(p_shuffle=0.3),
        dict(p_stale=0.1, p_dup=0.05, p_lose=0.05, p_shuffle=0.1)]


@pytest.mark.parametrize("cfg", FUZZ, ids=[",".join(c) or "clean"
                                           for c in FUZZ])
def test_columnar_matches_reference_fuzz(cfg):
    """Both of the port's analyses equal each other and the reference's
    columnar analysis, on every fuzz history."""
    rng = random.Random(42 + len(cfg))
    for trial in range(6):
        h, rh = both(gen_set_history(rng, **cfg))
        got = _analyze_columnar(h)
        assert got == _analyze_reference(h), (cfg, trial)
        assert got == ref_sf._analyze_columnar(rh), (cfg, trial)
        _same_dict(SetFull(True).check({}, h),
                   ref_sf.SetFull(True).check({}, rh))


def test_columnar_empty_and_read_only():
    for ops in ([], flat(read(0, []))):
        h, rh = both(ops)
        assert _analyze_columnar(h) == _analyze_reference(h) == \
            ref_sf._analyze_reference(rh)


def test_non_int_values_fall_back_to_reference():
    ops = flat(
        ({"type": "invoke", "process": 0, "f": "add", "value": "a"},
         {"type": "ok", "process": 0, "f": "add", "value": "a"}),
        ({"type": "invoke", "process": 1, "f": "read", "value": None},
         {"type": "ok", "process": 1, "f": "read", "value": ["a"]}))
    h, rh = both(ops)
    with pytest.raises(_NonColumnar):
        _analyze_columnar(h)
    assert analyze(h) == _analyze_reference(h) == ref_sf.analyze(rh)
    assert SetFull().check({}, h)["valid?"] is True
    with pytest.raises(_NonColumnar):
        ColumnScan().feed(columns_of(both(indexed(ops))[0].ops))


def _scan(cols, cuts):
    scan = ColumnScan()
    bounds = [0] + sorted(set(cuts)) + [len(cols)]
    for lo, hi in zip(bounds, bounds[1:]):
        if hi > lo:
            scan.feed(_slice_columns(cols, lo, hi))
    return scan.finish()


def _same_scan(a, b, what):
    assert type(a) is type(b), what
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _same_scan(a[k], b[k], (what, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_scan(x, y, (what, i))
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b) and a.dtype == b.dtype, what
    else:
        assert a == b, what


@pytest.mark.parametrize("cfg", [FUZZ[0], FUZZ[-1]],
                         ids=["clean", "all-anomalies"])
def test_column_scan_in_chunks_equals_one_shot(cfg):
    """``ColumnScan`` fed a row at a time, in prime-width chunks or in
    one piece finishes to the same artifact, and ``analyze`` with it
    equals ``analyze`` without it; so does the reference's scan over
    the same columns."""
    rng = random.Random(7)
    for trial in range(3):
        ops = indexed(gen_set_history(rng, n_ops=200, **cfg))
        h, _ = both(ops)
        cols = columns_of(h.ops)
        one = _scan(cols, [])
        for cuts in (list(range(1, len(cols))),
                     list(range(13, len(cols), 13))):
            _same_scan(_scan(cols, cuts), one, (trial, len(cuts)))
        hc = History.from_columns(cols)
        assert analyze(hc, _scan=one) == analyze(hc) == \
            _analyze_reference(h)
        rscan = ref_sf.ColumnScan()
        rscan.feed(cols)
        want = rscan.finish()
        assert json.dumps(one, sort_keys=True, default=repr) == \
            json.dumps(want, sort_keys=True, default=repr)


def test_epoch_v3_set_histories_get_the_references_verdicts():
    """Set histories from the port's epoch-v3 generator on the CPU (the
    draws' plain version) equal the reference's and get its SetFull
    dicts, checked column-backed and through ``_analyze_reference``."""
    import jax
    from jepsen_etcd_tpu.simbatch import generate_for_opts as ref_gen
    from jepsen_etcd_tpu_torch.simbatch import generate_for_opts
    opts = {"workload": "set", "concurrency": 8, "rate": 500.0,
            "time_limit": 1.0, "gen_epoch": "epoch-v3",
            "nemesis": ["kill"]}
    seeds = [0, 1, 2]
    got = generate_for_opts(dict(opts), seeds, device="cpu")
    with jax.threefry_partitionable(False):
        want = ref_gen(dict(opts), seeds)
    assert got["epoch"] == want["epoch"] == "epoch-v3"
    for h, rh in zip(got["histories"], want["histories"]):
        assert h.to_jsonl() == rh.to_jsonl() and len(h) > 100
        res = SetFull(linearizable=True).check({}, h)
        _same_dict(res, ref_sf.SetFull(linearizable=True).check({}, rh))
        assert sf.analyze(h) == _analyze_reference(History(h.ops))
        assert res["valid?"] is True
