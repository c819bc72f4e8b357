"""The traffic: the frozen synthesizer against the program's own, the
assembled histories against the pool, and the program keeping nothing
from one history for the next."""

from __future__ import annotations

import glob
import json
import os
import random

import pytest

from jepsen_etcd_tpu_torch.core.history import History, columns_of
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.runner import telemetry

from benchmark.entries import register as entry_mod
from benchmark.lib import spec
from benchmark.run import ROOT
from benchmark.traffic import register_pool
from benchmark.reference import register as ref
from benchmark.traffic.synth import gen_register_history

SHAPE = {"readers": 5, "writers": 5, "values": 5, "concurrency": 20}
SMALL = {**SHAPE, "ops_per_key": 300, "keys_per_history": [10, 12],
         "pool": {"clean": 14, "corrupt": 3, "faulted": 3},
         "corrupt_every": 4, "faulted_per_history": [1, 2],
         "info_rate": 0.02,
         "warmup": [{"keys": 12, "faulted": 2, "corrupt": 1}]}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 1, 2 ** 40 + 2])
def test_a_key_has_register_clj_shape(seed):
    """Five threads only read, five write and CAS one to one, values
    0 to 4; a timed-out read completes :fail, a timed-out update :info,
    and its thread goes on as process + concurrency."""
    ops = gen_register_history(random.Random(seed), n_ops=2000,
                               info_rate=0.02, **SHAPE)
    assert len(ops) == 4000
    open_by = {}
    retired = set()
    writes = cas = 0
    for o in ops:
        p = o["process"]
        assert p not in retired
        thread = p % SHAPE["concurrency"]
        assert 0 <= thread < 10
        assert (o["f"] == "read") == (thread < 5)
        if o["type"] == "invoke":
            assert p not in open_by
            open_by[p] = o
            arg = o["value"][1]
            if o["f"] == "write":
                writes += 1
                assert arg in range(5)
            elif o["f"] == "cas":
                cas += 1
                assert all(v in range(5) for v in arg)
            continue
        inv = open_by.pop(p)
        assert inv["f"] == o["f"]
        if o["type"] == "info":
            assert o["f"] != "read" and o["error"] == "timeout"
            retired.add(p)
        elif o["type"] == "fail":
            assert o.get("error") == ("timeout" if o["f"] == "read"
                                      else "did-not-succeed") or \
                o["f"] == "cas"
    assert not open_by
    assert retired, "some update timed out"
    assert abs(writes - cas) < 0.1 * (writes + cas)
    # linearizable by construction, with its sessions held
    v = ref.key_verdict(ops)
    assert v["linear"] and v["session"]


def test_a_corrupted_key_is_the_same_ops_misreported():
    for seed in range(4):
        clean = gen_register_history(random.Random(seed), n_ops=600,
                                     **SHAPE)
        bad = gen_register_history(random.Random(seed), n_ops=600,
                                   corrupt=True, **SHAPE)
        assert [(o["type"], o["process"], o["f"]) for o in clean] == \
            [(o["type"], o["process"], o["f"]) for o in bad]
        assert clean != bad
        assert ref.key_verdict(bad)["linear"] is False


def _dict_history(keys, i):
    """The same history built the slow way: dict ops, keyed as
    ``testing.keyed`` keys them, then ``columns_of``."""
    label0 = entry_mod.labels(i, keys)[0]
    ops = []
    for s, k in enumerate(keys):
        for o in k.ops:
            ops.append(Op({**o, "value": (label0 + s, o["value"]),
                           "process": o["process"]
                           + register_pool.PROC_STRIDE * s}))
    ops = [op.evolve(time=t, index=t) for t, op in enumerate(ops)]
    return History(ops, columns=columns_of(ops))


def test_assembled_columns_equal_the_recorded_form():
    traffic = register_pool.make(SMALL, 2 ** 40 + 7)
    entry = entry_mod.Entry({"nodes": 5, "concurrency": 20,
                             "ops_per_key": 300}, device="cpu")
    for i in range(6):
        keys = traffic.history(i)
        ours = entry.history(keys, i).columns
        ref = _dict_history(keys, i).columns
        for name in ("type_code", "proc", "key_id", "time", "index"):
            assert (getattr(ours, name) == getattr(ref, name)).all(), name
        assert [ours.f_table[c] for c in ours.f_code] == \
            [ref.f_table[c] for c in ref.f_code]
        assert ours.values == ref.values
        assert ours.extras == ref.extras
        assert ours.key_table == ref.key_table
        subs = History.from_columns(ours).split_by_key()
        for s, k in enumerate(keys):
            sub = subs[entry_mod.labels(i, keys)[s]]
            assert [(o["type"], o["f"], o["value"],
                     o["process"] - register_pool.PROC_STRIDE * s,
                     o.get("error")) for o in sub] == \
                [(o["type"], o["f"], o["value"], o["process"],
                  o.get("error")) for o in k.ops]


def test_same_seed_same_traffic_and_every_seed_the_same_mix():
    def draw(seed, n=24):
        t = register_pool.make(SMALL, seed)
        return [[k.name for k in t.history(i)] for i in range(n)], t

    a, ta = draw(2 ** 33 + 1)
    b, tb = draw(2 ** 33 + 1)
    c, tc = draw(2 ** 33 + 2)
    assert a == b
    assert [k.ops for k in ta.keys()] == [k.ops for k in tb.keys()]
    assert a != c
    # the same sizes and mix in every seed: key counts a cycle, one
    # corrupted key a block of four, faulted 1 and 2 a block of two
    for names in (a, c):
        sizes = [len(h) for h in names]
        assert sorted(sizes[:3]) == [10, 11, 12]
        assert sorted(sizes[3:6]) == [10, 11, 12]
        corrupt = [sum(r == "corrupt" for r, _ in h) for h in names]
        assert all(sum(corrupt[j:j + 4]) == 1 for j in range(0, 24, 4))
        faulted = [sum(r == "faulted" for r, _ in h) for h in names]
        assert all(sorted(faulted[j:j + 2]) == [1, 2]
                   for j in range(0, 24, 2))
        assert all(len(set(h)) == len(h) for h in names)


def _record(entry, history):
    tel = telemetry.Telemetry(path=None)
    telemetry.set_current(tel)
    try:
        out = entry.check(history)
    finally:
        telemetry.set_current(None)
    summary = tel.summary()
    return out, {n: v["count"] for n, v in summary["spans"].items()}, \
        summary["counters"]


def test_a_pooled_history_checked_twice_records_the_same():
    """The program keeps nothing keyed on a history or its ops: the
    same pooled keys, assembled twice into fresh histories, record the
    same spans and counters and get the same verdict."""
    traffic = register_pool.make(SMALL, 99)
    entry = entry_mod.Entry({"nodes": 5, "concurrency": 20,
                             "ops_per_key": 300}, device="cpu")
    keys = traffic.history(1)
    first = _record(entry, entry.history(keys, 1))
    again = _record(entry, entry.history(keys, 1))
    assert first[1] == again[1]
    assert first[2] == again[2]
    assert first[0] == again[0]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "cells", "*.json"))),
    ids=os.path.basename)
def test_every_cell_files_traffic_draws_its_mix(path):
    """Each cell file gives histories of its own sizes and roles."""
    name = os.path.basename(path)[:-len(".json")]
    cell = spec.load(ROOT, name)
    params = cell.spec["params"]
    traffic = cell.traffic(2 ** 34 + 5)
    lo, hi = params["keys_per_history"]
    for i in range(2 * (hi - lo + 1)):
        keys = traffic.history(i)
        assert lo <= len(keys) <= hi
        assert {k.role for k in keys} <= {"clean", "corrupt", "faulted"}
    warm = traffic.warmup()
    assert [len(w) for w in warm] == [w["keys"] for w in params["warmup"]]
