"""Twin of the reference's ``tests/test_nemesis.py`` on the port: every
fault package runs end to end through the port's ``etcd_test`` →
``run_test`` (``device="cpu"``), with the reference's assertions, and
each run's history bytes, verdict dicts, ``test.json`` and timeline
equal the reference's run on the same opts (``run_test_both``). The
sim-level cases run on both packages and compare what they observe."""

from jepsen_etcd_tpu.cli import parse_nemesis_spec as ref_parse_nemesis_spec
from jepsen_etcd_tpu_torch.cli import parse_nemesis_spec
from test_torch_fixtures import both, mod, one_torch_thread  # noqa: F401
from test_torch_fixtures import run_test_both

BASE = {"time_limit": 20, "rate": 25, "ops_per_key": 50, "seed": 3,
        "nemesis_interval": 3}


def run(tmp_path, **opts):
    port, _, _, _ = run_test_both(tmp_path, dict(BASE, **opts))
    return port


def test_parse_nemesis_spec():
    assert parse_nemesis_spec("kill,pause") == ["kill", "pause"]
    assert parse_nemesis_spec("none") == []
    assert "bitflip-wal" in parse_nemesis_spec("corrupt")
    assert "member" in parse_nemesis_spec("all")
    for spec in ("kill,pause", "none", "corrupt", "all", "partition",
                 "clock,member"):
        assert parse_nemesis_spec(spec) == ref_parse_nemesis_spec(spec)


def nemesis_fs(history):
    return {op.f for op in history if op.get("process") == "nemesis"
            and op.get("type") == "info"}


def test_register_under_kill(tmp_path):
    out = run(tmp_path, workload="register", nemesis=["kill"])
    assert out["results"]["workload"]["valid?"] is True, \
        "kill faults must not break linearizability"
    assert {"kill", "start"} & nemesis_fs(out["history"])
    per_key = out["results"]["workload"]["results"]
    checkers = [r["linear"].get("checker") for r in per_key.values()]
    assert checkers and all(c in ("tpu-wgl", "cpu-oracle")
                            for c in checkers), checkers
    assert any(r["linear"].get("info-ops", 0) > 0
               for r in per_key.values()), \
        "kill run should produce at least one indefinite op"


def test_register_under_partition(tmp_path):
    out = run(tmp_path, workload="register", nemesis=["partition"])
    assert out["results"]["workload"]["valid?"] is True, \
        "partitions must not break linearizability"
    assert "start-partition" in nemesis_fs(out["history"])


def test_register_under_latency(tmp_path):
    out = run(tmp_path, workload="register", nemesis=["latency"])
    assert out["results"]["workload"]["valid?"] is True, \
        "latency must not break linearizability"
    assert "start-latency" in nemesis_fs(out["history"])


def _directed_partition(pkg):
    sim = mod(pkg, "runner.sim")
    cl = mod(pkg, "sut.cluster")
    loop = sim.SimLoop(seed=1)
    sim.set_current_loop(loop)
    seen = []
    try:
        cluster = cl.Cluster(loop, ["n1", "n2", "n3"], cl.ClusterConfig())
        cluster.launch()
        loop.run_coro(sim.sleep(sim.SECOND // 1000))
        cluster.partition_pairs({("n1", "n2")})
        assert cluster.reachable("n1", "n2") is False
        assert cluster.reachable("n2", "n1") is True
        assert cluster.reachable("n1", "n3") is True
        cluster.partition_pairs({frozenset(("n1", "n2"))})
        assert cluster.reachable("n1", "n2") is False
        assert cluster.reachable("n2", "n1") is False
        cluster.heal_partition()
        assert cluster.reachable("n1", "n2") is True
        base = (10, 20)
        cluster.set_latency(50, jitter_ms=10)
        assert cluster.net_latency is not None
        seen.append(cluster.msg_delay(base))
        assert seen[-1] > base[1]
        cluster.clear_latency()
        assert cluster.net_latency is None
        seen.append(cluster.msg_delay(base))
        assert base[0] <= seen[-1] <= base[1]
        seen.append(loop.now)
        cluster.shutdown()
    finally:
        sim.set_current_loop(None)
    return seen


def test_sim_directed_partition_blocks_one_direction():
    """Ordered (src, dst) pairs block exactly one direction in the sim;
    frozensets block both; the latency knob's draws are the
    reference's."""
    both(_directed_partition)


def _partition_shapes(pkg):
    sim = mod(pkg, "runner.sim")
    cl = mod(pkg, "sut.cluster")
    faults = mod(pkg, "nemesis.faults")
    loop = sim.SimLoop(seed=2)
    sim.set_current_loop(loop)
    try:
        nodes = ["n1", "n2", "n3", "n4", "n5"]
        cluster = cl.Cluster(loop, nodes, cl.ClusterConfig())
        test = {"cluster": cluster}
        ow = faults._partition_groups(test, "one-way", [])
        assert isinstance(ow, set) and len(ow) == 4
        srcs = {p[0] for p in ow}
        assert len(srcs) == 1
        assert all(isinstance(p, tuple) and not isinstance(p, frozenset)
                   for p in ow)
        br = faults._partition_groups(test, "bridge", [])
        assert isinstance(br, set) and br
        assert all(isinstance(p, frozenset) for p in br)
        assert len(br) == 4
        blocked_nodes = set().union(*br)
        assert len(blocked_nodes) == 4
        bridge = (set(nodes) - blocked_nodes).pop()
        assert all(bridge not in pair for pair in br)
    finally:
        sim.set_current_loop(None)
    return ow, br


def test_partition_spec_shapes():
    """One-way is a single source's outbound tuples; bridge splits the
    rest into two halves blocked pairwise; the seeded picks are the
    reference's."""
    both(_partition_shapes)


def test_register_under_pause_clock(tmp_path):
    out = run(tmp_path, workload="register", nemesis=["pause", "clock"],
              time_limit=40)
    assert out["results"]["workload"]["valid?"] is True
    assert out["results"]["crash"]["valid?"] is True, \
        out["results"]["crash"]["matches"][:3]
    assert out["valid?"] is True
    fs = nemesis_fs(out["history"])
    assert "pause" in fs
    assert fs & {"bump-clock", "strobe-clock", "reset-clock"}


def test_register_under_member(tmp_path):
    out = run(tmp_path, workload="register", nemesis=["member"],
              time_limit=25)
    assert out["results"]["workload"]["valid?"] is True
    assert {"grow", "shrink"} & nemesis_fs(out["history"])


def test_member_heals_to_full(tmp_path):
    _, _, test, _ = run_test_both(
        tmp_path, {"workload": "register", "nemesis": ["member"],
                   "time_limit": 25, "rate": 25, "ops_per_key": 50,
                   "seed": 5, "nemesis_interval": 3},
        test_hook=lambda t: sorted(t["db"].members))
    assert len(test["db"].members) >= len(test["nodes"])


def test_set_under_admin_compact(tmp_path):
    out = run(tmp_path, workload="set", nemesis=["admin"])
    assert out["results"]["workload"]["valid?"] is True
    assert {"compact", "defrag"} & nemesis_fs(out["history"])


def test_append_under_kill_bitflip(tmp_path):
    out = run(tmp_path, workload="append",
              nemesis=["kill", "bitflip-wal", "bitflip-snap"],
              time_limit=25)
    wl = out["results"]["workload"]
    assert wl["valid?"] is True, wl.get("anomaly-types")


def test_watch_under_kill(tmp_path):
    out = run(tmp_path, workload="watch", nemesis=["kill"])
    wl = out["results"]["workload"]
    assert wl["valid?"] in (True, "unknown"), wl


def test_lock_set_breaks_under_clock_faults(tmp_path):
    """Skewing the leader's clock expires the holder's lease mid
    critical section; a second holder acquires; adds are lost. Both
    seeds' runs equal the reference's."""
    failures = 0
    for seed in range(2):
        out = run(tmp_path / str(seed), workload="lock-set",
                  nemesis=["clock"], time_limit=60, rate=10, seed=seed,
                  nemesis_interval=2)
        wl = out["results"]["workload"]["set"]
        if wl["valid?"] is not True and wl.get("lost"):
            failures += 1
    assert failures > 0, \
        "etcd locks should demonstrably fail under clock faults"
