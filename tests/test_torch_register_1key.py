"""One long register key through the register workload's own checker
on the CPU, held to the benchmark's plain reference: the route of the
single-key cell (``register_1key_10k.faulted``).

A key past ``DFS_FIRST_MAX`` entries, alone in its history, skips the
native DFS. Holding :info ops, B1 cannot take it, so it climbs the lone
ladder from rung 32 (``check_packed``), its frames built once
(``wgl.frames``, inside ``wgl.tables``). A corrupted key of that size
goes to B1 single and is refuted there. Both verdicts, the session
verdicts and their violation counts equal the reference's.
"""

import random

import pytest

from benchmark.entries import register as entry_mod
from benchmark.reference import register as ref
from benchmark.traffic.register_pool import PoolKey
from benchmark.traffic.synth import gen_register_history
from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import DFS_FIRST_MAX
from jepsen_etcd_tpu_torch.runner import telemetry

#: just past the DFS-first band: 13,200 entries
N_OPS = 6600
SHAPE = {"readers": 5, "writers": 5, "values": 5, "concurrency": 10}


def _key(role: str) -> PoolKey:
    ops = gen_register_history(random.Random(5), n_ops=N_OPS,
                               corrupt=role == "corrupt",
                               info_rate=0.01 if role == "faulted" else 0.0,
                               **SHAPE)
    return PoolKey(role, 0, ops)


def _check(entry, key, i, path):
    tel = telemetry.Telemetry(path=str(path), max_records=10 ** 6)
    telemetry.set_current(tel)
    try:
        out = entry.check(entry.history([key], i))
    finally:
        telemetry.set_current(None)
        tel.close()
    spans = [r for r in telemetry.load_jsonl(str(path))[0]
             if r.get("kind") == "span"]
    return entry.summarize(out, [key], i), spans


@pytest.fixture(scope="module")
def entry():
    return entry_mod.Entry({"nodes": 5, "concurrency": 10,
                            "ops_per_key": N_OPS}, device="cpu")


def _holds_to_the_reference(got, key):
    exp = [ref.key_verdict(key.ops)]
    wrong, unknown = ref.compare(got, exp)
    assert wrong == dict.fromkeys(ref.LIMITS, 0)
    assert unknown == 0
    g = got["keys"][0]
    assert (g["linear"], g["session"], g["violations"]) == \
        (exp[0]["linear"], exp[0]["session"], exp[0]["violations"])
    return g


def test_a_faulted_key_past_the_band_climbs_the_lone_ladder(entry,
                                                            tmp_path):
    key = _key("faulted")
    assert len(key) == 2 * N_OPS > DFS_FIRST_MAX
    assert any(o["type"] == "info" for o in key.ops)
    got, spans = _check(entry, key, 0, tmp_path / "spans.jsonl")
    g = _holds_to_the_reference(got, key)
    assert g["linear"] is True and g["session"] is True
    assert g["engine"] == "jnp-ladder"
    assert g["batched"] is False
    assert g["route"] is None
    assert g["waves"] > 0
    frames = [s for s in spans if s["name"] == "wgl.frames"]
    tables = [s for s in spans if s["name"] == "wgl.tables"]
    assert len(frames) == 1
    f = frames[0]
    assert sum(t["t0"] <= f["t0"] and f["t1"] <= t["t1"]
               for t in tables) == 1
    assert f["attrs"]["infos"] > 0 and f["attrs"]["w"] == 32


def test_a_corrupted_key_past_the_band_is_refuted_by_b1(entry, tmp_path):
    key = _key("corrupt")
    assert len(key) == 2 * N_OPS
    got, spans = _check(entry, key, 1, tmp_path / "spans.jsonl")
    g = _holds_to_the_reference(got, key)
    assert g["linear"] is False and g["session"] is False
    assert g["violations"] > 0
    assert g["engine"] == "mxu-wave"
    assert got["valid?"] is False
    # B1 builds its own tables: the ladder's frames are never built
    assert not [s for s in spans if s["name"] == "wgl.frames"]
