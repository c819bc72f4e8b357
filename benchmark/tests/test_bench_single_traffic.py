"""The single-key traffic (``traffic/register_single.py``): one key a
history, three faulted to one corrupted in every block of four, faulted
keys the same in every seed, the warm-up apart from the turns, and the
cell's files found by name."""

from __future__ import annotations

import pytest

from benchmark.lib import spec
from benchmark.run import ROOT
from benchmark.traffic import register_single

CELL = "register_1key_10k.faulted"
SHAPE = {"readers": 5, "writers": 5, "values": 5, "concurrency": 10}
SMALL = {**SHAPE, "ops_per_key": 200, "keys_per_history": [1, 1],
         "pool": {"faulted": 4, "corrupt": 2},
         "corrupt_every": 4, "info_rate": 0.1,
         "warmup": [{"keys": 1, "faulted": 1}, {"keys": 1, "corrupt": 1}]}


def draw(seed: int, n: int = 32, params=SMALL):
    t = register_single.make(params, seed)
    return t, [t.history(i) for i in range(n)]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3, 2 ** 40 + 9])
def test_one_key_a_history_three_faulted_to_one_corrupted(seed):
    _, hs = draw(seed)
    assert all(len(h) == 1 for h in hs)
    roles = [h[0].role for h in hs]
    for j in range(0, len(roles), 4):
        assert sorted(roles[j:j + 4]) == ["corrupt"] + ["faulted"] * 3
    # the corrupted slot is drawn per block, not fixed
    slots = {roles[j:j + 4].index("corrupt") for j in range(0, 32, 4)}
    assert len(slots) > 1


def test_each_roles_keys_are_used_in_turn():
    t, hs = draw(2 ** 33 + 1, n=48)
    faulted = [h[0].index for h in hs if h[0].role == "faulted"]
    corrupt = [h[0].index for h in hs if h[0].role == "corrupt"]
    # a fresh shuffle of the pool a round: every key once a round
    for keys, n in ((faulted, 4), (corrupt, 2)):
        for j in range(0, len(keys) - n + 1, n):
            assert sorted(keys[j:j + n]) == list(range(n))


def test_faulted_keys_are_fixed_and_corrupted_keys_the_seeds():
    a, ha = draw(2 ** 33 + 1)
    b, hb = draw(2 ** 33 + 1)
    c, _ = draw(2 ** 33 + 2)
    assert [k.ops for r in register_single.ROLES for k in a.pool[r]] == \
        [k.ops for r in register_single.ROLES for k in b.pool[r]]
    assert [[k.name for k in h] for h in ha] == \
        [[k.name for k in h] for h in hb]
    assert [k.ops for k in a.pool["faulted"]] == \
        [k.ops for k in c.pool["faulted"]]
    for x, y in zip(a.pool["corrupt"], c.pool["corrupt"]):
        assert x.ops != y.ops
    assert all(any(o["type"] == "info" for o in k.ops)
               for k in a.pool["faulted"])
    assert not any(o["type"] == "info" for k in a.pool["corrupt"]
                   for o in k.ops)


def test_the_warmup_is_drawn_apart_from_the_turns():
    a = register_single.make(SMALL, 2 ** 34 + 5)
    warm = a.warmup()
    assert [[k.role for k in w] for w in warm] == [["faulted"],
                                                   ["corrupt"]]
    b = register_single.make(SMALL, 2 ** 34 + 5)
    # drawing the warm-up moves no turn: the window's keys are the same
    assert [a.history(i)[0].name for i in range(16)] == \
        [b.history(i)[0].name for i in range(16)]
    assert [[k.name for k in w] for w in a.warmup()] == \
        [[k.name for k in w] for w in warm]


def test_more_than_one_key_a_history_is_refused():
    with pytest.raises(ValueError):
        register_single.make({**SMALL, "keys_per_history": [1, 2]}, 1)


def test_a_key_holds_27000_entries_at_13500_ops():
    params = {**SMALL, "ops_per_key": 13500,
              "pool": {"faulted": 1, "corrupt": 1}}
    t = register_single.make(params, 2 ** 35 + 7)
    assert [len(k) for r in register_single.ROLES for k in t.pool[r]] == \
        [27000, 27000]
    # a timed-out update moves its thread on by the concurrency: 10
    procs = {o["process"] for o in t.pool["faulted"][0].ops}
    assert min(procs) == 0 and any(p >= 10 for p in procs)


def test_the_cell_files_are_found_by_name():
    cell = spec.load(ROOT, CELL)
    assert cell.chips == 1
    assert cell.config["ops_per_key"] == 13500
    assert cell.config["concurrency"] == 10
    assert cell.config["reduced"] == []
    assert cell.module("traffic") is spec.load_module(
        ROOT, "traffic", "register_single")
    per_layer = {m["name"] for m, _ in cell.per_layer}
    assert {"frames_ms", "rung_kernel_roofline",
            "device_idle_share"} <= per_layer
    # readers listed for the other cell alone are not this cell's
    assert "ladder_ms_per_op" not in per_layer
    assert {m["name"] for m, _ in cell.end_to_end} == \
        {"ops_per_s", "verdict_p50_s", "setup_s"}
    other = spec.load(ROOT, "register_4n_2000.faulted")
    assert not {"frames_ms", "rung_kernel_roofline"} & \
        {m["name"] for m, _ in other.per_layer}
