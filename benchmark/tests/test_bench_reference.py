"""The plain reference against the program's CPU route, against a
search with no reductions, and the comparison against its control."""

from __future__ import annotations

import itertools
import json
import os
import random

import pytest

from benchmark.entries import register as entry_mod
from benchmark.reference import register as ref
from benchmark.run import ROOT
from benchmark.traffic import register_pool
from benchmark.traffic.synth import gen_register_history


with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]


def _plain_search(ops) -> bool:
    """Linearizability by brute force: every order of the ops that may
    have taken effect which keeps real time, with any subset of the
    indefinite ones, run through the model. Tiny histories only."""
    es = ref._entries(ops)
    # the reference leaves :info reads out; so may this search, as they
    # change no state
    req = [e for e in es if e[4]]
    opt = [e for e in es if not e[4]]
    for n in range(len(opt) + 1):
        for chosen in itertools.combinations(opt, n):
            picked = req + list(chosen)
            for order in itertools.permutations(picked):
                # real time: an op returned before another's invoke
                # comes first
                if any(a[3] < b[2] for j, b in enumerate(order)
                       for a in order[j + 1:]):
                    continue
                version, value = 0, None
                for e in order:
                    s = ref._step(version, value, e[0], e[1])
                    if s is None:
                        break
                    version, value = s
                else:
                    return True
    return False


@pytest.mark.parametrize("seed", range(40))
def test_reference_equals_brute_force_on_tiny_histories(seed):
    rng = random.Random(seed)
    ops = gen_register_history(rng, readers=1, writers=2, n_ops=6,
                               values=3, corrupt=seed % 3 == 0,
                               info_rate=0.3 if seed % 2 else 0.0)
    assert ref.linearizable(ops)["valid?"] == _plain_search(ops)


CPU_PARAMS = {"readers": 5, "writers": 5, "values": 5, "concurrency": 20,
              "ops_per_key": 300, "keys_per_history": [10, 10],
              "pool": {"clean": 10, "corrupt": 4, "faulted": 4},
              "corrupt_every": 1, "faulted_per_history": [1, 2],
              "info_rate": 0.02}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 2 ** 40 + 3])
def test_reference_agrees_with_the_programs_cpu_route(seed):
    """Valid, corrupted and :info keys through the register workload's
    checker on the CPU (``device="cpu"``: B1's plain version, the
    ladder and the native DFS), key by key and merged."""
    traffic = register_pool.make(CPU_PARAMS, seed)
    entry = entry_mod.Entry({"nodes": 5, "concurrency": 20,
                             "ops_per_key": 300}, device="cpu")
    seen = set()
    for i in range(4):
        keys = traffic.history(i)
        got = entry.summarize(entry.check(entry.history(keys, i)), keys, i)
        exp = [ref.key_verdict(k.ops) for k in keys]
        wrong, unknown = ref.compare(got, exp)
        assert wrong == dict.fromkeys(ref.LIMITS, 0)
        assert unknown == 0
        seen |= {(k.role, e["linear"]) for k, e in zip(keys, exp)}
        seen |= {g["engine"] for g in got["keys"]}
    # the cases this covers: clean and faulted keys valid, corrupted
    # keys refuted, on B1 and on the ladder
    assert {("clean", True), ("faulted", True), ("corrupt", False)} <= seen
    assert {"mxu-wave", "jnp-ladder"} <= seen


def test_compare_counts_what_differs():
    exp = [{"linear": True, "session": True, "violations": 0, "depth": 9},
           {"linear": False, "session": False, "violations": 2,
            "depth": 3}]

    def got(keys, valid=False, extra=0):
        return {"valid?": valid, "keys": keys, "extra": extra}

    ok = [{"linear": True, "session": True, "violations": 0},
          {"linear": False, "session": False, "violations": 2}]
    zero = dict.fromkeys(ref.LIMITS, 0)
    assert ref.compare(got(ok), exp) == (zero, 0)
    flipped = [ok[0], dict(ok[1], linear=True)]
    assert ref.compare(got(flipped), exp)[0]["linear"] == 1
    fewer = [ok[0], dict(ok[1], violations=1)]
    assert ref.compare(got(fewer), exp)[0]["session"] == 1
    missing = ref.compare(got([ok[0], None]), exp)[0]
    assert missing["linear"] == missing["session"] == 1
    assert ref.compare(got(ok, valid=True), exp)[0]["valid"] == 1
    assert ref.compare(got(ok, extra=1), exp)[0]["valid"] == 1
    unsure = [dict(ok[0], linear="unknown"), ok[1]]
    assert ref.compare(got(unsure), exp) == (zero, 1)


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 11, 2 ** 41 + 17])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    """The control (session guarantees without monotone reads in the
    system's place) reads not correct on each cell's own traffic, over
    the first eight histories a run with the seed checks."""
    from benchmark.control import control_run
    out = control_run(ROOT, cell, seed, 8)
    assert out["correct"] is False
    assert out["compared"]["session"]["value"] > 0
