"""Twin of the reference's ``tests/test_config_plane.py`` on the port:
CLI opts reach the simulated cluster (``--snapshot-count``,
``--unsafe-no-fsync``), the ``--corrupt-check`` monitor catches silent
divergence, the fault matrix and ``test-all``'s matrix. Each run is held
to the reference's run on the same opts (``run_test_both``: history
bytes, dicts, ``test.json``, timeline) and to the reference's cluster
state; the cluster-level cases run on both packages (``both``)."""

from jepsen_etcd_tpu import cli as ref_cli
from jepsen_etcd_tpu.compose import fault_matrix as ref_fault_matrix
from jepsen_etcd_tpu_torch.cli import build_parser, opts_from_args
from jepsen_etcd_tpu_torch.cli import test_all_matrix as _test_all_matrix
from jepsen_etcd_tpu_torch.workloads import ALL_WORKLOADS, \
    WORKLOADS_EXPECTED_TO_PASS
from test_torch_fixtures import PORT, both, mod, run_test_both
from test_torch_fixtures import one_torch_thread  # noqa: F401

BASE = {"time_limit": 6, "rate": 50, "ops_per_key": 30, "seed": 7}


def cluster_state(test) -> dict:
    c = test["cluster"]
    return {"cfg": (c.cfg.snapshot_count, c.cfg.unsafe_no_fsync,
                    c.cfg.corrupt_check),
            "snaps": {k: n.snap_index for k, n in c.nodes.items()},
            "logs": {k: list(n.etcd_log) for k, n in c.nodes.items()},
            "fp": {k: dict(n.fp_ledger) for k, n in c.nodes.items()}}


def run(tmp_path, **opts):
    out, _, test, _ = run_test_both(tmp_path, dict(BASE, **opts),
                                    test_hook=cluster_state)
    out = dict(out)
    out["test"] = test
    return out


# ---- snapshot-count / unsafe-no-fsync threading ---------------------------

def test_snapshot_count_reaches_cluster_and_changes_cadence(tmp_path):
    out = run(tmp_path, workload="register", snapshot_count=5)
    cluster = out["test"]["cluster"]
    assert cluster.cfg.snapshot_count == 5
    snaps = [n.snap_index for n in cluster.nodes.values()]
    assert max(snaps) > 0, "no node ever snapshotted at count=5"
    saved = [line for node in cluster.nodes.values()
             for line in node.etcd_log if "saved snapshot" in line]
    assert saved


def test_unsafe_no_fsync_reaches_cluster(tmp_path):
    out = run(tmp_path / "a", workload="register", unsafe_no_fsync=True)
    assert out["test"]["cluster"].cfg.unsafe_no_fsync is True
    out2 = run(tmp_path / "b", workload="register")
    assert out2["test"]["cluster"].cfg.unsafe_no_fsync is False


def _opts(pkg, argv) -> dict:
    cli = mod(pkg, "cli")
    opts = cli.opts_from_args(cli.build_parser().parse_args(argv))
    if pkg == PORT:
        assert opts.pop("device") == "cuda"
    return opts


def test_cli_flags_reach_opts():
    args = build_parser().parse_args(
        ["test", "--snapshot-count", "7", "--unsafe-no-fsync",
         "--corrupt-check", "-v", "sim-3.5.6"])
    opts = opts_from_args(args)
    assert opts["snapshot_count"] == 7
    assert opts["unsafe_no_fsync"] is True
    assert opts["corrupt_check"] is True
    assert opts["version"] == "sim-3.5.6"
    d = opts_from_args(build_parser().parse_args(["test"]))
    assert d["workload"] == "register"
    assert d["snapshot_count"] == 100
    assert d["unsafe_no_fsync"] is False
    assert d["corrupt_check"] is False
    assert d["net_proxy"] is False
    p = opts_from_args(build_parser().parse_args(["test", "--net-proxy"]))
    assert p["net_proxy"] is True
    # every key and value the reference's parser gives, and ``device``
    for argv in (["test", "--snapshot-count", "7", "--unsafe-no-fsync",
                  "--corrupt-check", "-v", "sim-3.5.6"], ["test"],
                 ["test", "--net-proxy"]):
        both(_opts, argv)


# ---- fault / privilege matrix (README table) -------------------------------

def test_fault_matrix_rows():
    from jepsen_etcd_tpu_torch.compose import fault_matrix
    from jepsen_etcd_tpu_torch.nemesis.faults import KNOWN_FAULTS
    local = fault_matrix("local")
    assert set(local) == set(KNOWN_FAULTS)
    assert local["partition"] == {"supported": True, "why": None}
    assert local["latency"] == {"supported": True, "why": None}
    for fault in ("kill", "pause", "member", "admin"):
        assert local[fault]["supported"] is True, fault
    assert local["clock"]["supported"] is False
    assert "CAP_SYS_TIME" in local["clock"]["why"]
    for fault in ("bitflip-wal", "bitflip-snap", "truncate-wal"):
        assert local[fault]["supported"] is False, fault
        assert "corruption" in local[fault]["why"], fault
    sim = fault_matrix("sim")
    assert all(row["supported"] for row in sim.values())
    live = fault_matrix("live")
    assert not any(row["supported"] for row in live.values())
    assert all(row["why"] for row in live.values())
    for mode in ("local", "sim", "live"):
        assert fault_matrix(mode) == ref_fault_matrix(mode), mode


# ---- corrupt-check monitor ------------------------------------------------

def _advance(pkg, cluster, loop, writes):
    """Drive enough writes through the leader for FP_EVERY-multiple
    fingerprints to be recorded on every node."""
    sim = mod(pkg, "runner.sim")
    direct = mod(pkg, "client.direct")

    async def go():
        c = direct.DirectClient(cluster, "n1")
        await c.await_node_ready()
        for i in range(writes):
            await c.put(f"k{i % 8}", f"v{i}")
    loop.run_coro(go())
    loop.run_coro(sim.sleep(2 * sim.SECOND))


def corrupt_cluster(pkg, body):
    """``body(cluster, loop)`` on a three-node cluster with the
    corruption check on, as the reference's fixture builds it."""
    sim = mod(pkg, "runner.sim")
    cl = mod(pkg, "sut.cluster")
    loop = sim.SimLoop(seed=3)
    sim.set_current_loop(loop)
    cluster = cl.Cluster(loop, ["n1", "n2", "n3"],
                         cl.ClusterConfig(corrupt_check=True))
    cluster.launch()
    try:
        return body(pkg, cluster, loop)
    finally:
        cluster.shutdown()
        sim.set_current_loop(None)


def _clean_cluster(pkg, cluster, loop):
    _advance(pkg, cluster, loop, 2 * mod(pkg, "sut.cluster").FP_EVERY)
    assert any(n.fp_ledger for n in cluster.nodes.values()), \
        "fingerprint ledger never recorded"
    assert cluster.check_corruption() == []
    assert cluster.corruption_alarms == []
    return {k: dict(n.fp_ledger) for k, n in cluster.nodes.items()}, \
        loop.now


def test_clean_cluster_no_alarm():
    both(corrupt_cluster, _clean_cluster)


def _bitflipped(pkg, cluster, loop):
    _advance(pkg, cluster, loop, 2 * mod(pkg, "sut.cluster").FP_EVERY)
    victim = cluster.nodes["n2"]
    key = sorted(victim.store.kvs)[0]
    victim.store.kvs[key].value = "corrupted-bits"
    for idx in victim.fp_ledger:
        victim.fp_ledger[idx] ^= 0xDEADBEEF
    alarms = cluster.check_corruption()
    assert alarms, "divergence not detected"
    assert any("n2" in a["nodes"] for a in alarms)
    check = mod(pkg, "checkers").LogFilePattern().check(
        {"cluster": cluster}, [])
    assert check["valid?"] is False
    assert any("data inconsistency" in m["line"] for m in check["matches"])
    n = len(cluster.corruption_alarms)
    cluster.check_corruption()
    assert len(cluster.corruption_alarms) == n
    return alarms, check


def test_bitflipped_but_replayable_node_trips_alarm():
    """A store that silently diverges raises the corruption alarm with
    a fatal log line the crash-pattern checker catches; the alarms and
    the checker's dict are the reference's."""
    both(corrupt_cluster, _bitflipped)


def test_corrupt_check_e2e_clean_run(tmp_path):
    out = run(tmp_path, workload="register", corrupt_check=True,
              time_limit=8)
    assert out["test"]["cluster"].cfg.corrupt_check is True
    cc = out["results"]["corrupt-check"]
    assert cc["valid?"] is True and cc["alarms"] == []
    assert out["valid?"] is True
    assert any(n.fp_ledger for n in
               out["test"]["cluster"].nodes.values())


# ---- test-all narrowing (etcd.clj:236-242) --------------------------------

def _args(extra):
    return build_parser().parse_args(["test-all"] + extra)


def _matrix(extra):
    got = _test_all_matrix(_args(extra))
    assert got == ref_cli.test_all_matrix(
        ref_cli.build_parser().parse_args(["test-all"] + extra))
    return got


def test_test_all_default_matrix():
    wls, nems = _matrix([])
    assert wls == ALL_WORKLOADS
    assert "none" not in wls
    assert len(nems) == 9
    from jepsen_etcd_tpu_torch.workloads import workloads
    assert set(ALL_WORKLOADS) == set(workloads()) - {"none"}


def test_test_all_workload_narrowing():
    wls, nems = _matrix(["-w", "set"])
    assert wls == ["set"] and len(nems) == 9


def test_test_all_nemesis_narrowing():
    wls, nems = _matrix(["--nemesis", "kill,partition"])
    assert nems == [["kill", "partition"]]
    assert wls == ALL_WORKLOADS


def test_expected_to_pass_matches_reference():
    from jepsen_etcd_tpu.workloads import WORKLOADS_EXPECTED_TO_PASS as REF
    assert "lock-etcd-set" in WORKLOADS_EXPECTED_TO_PASS
    assert "lock" not in WORKLOADS_EXPECTED_TO_PASS
    assert "lock-set" not in WORKLOADS_EXPECTED_TO_PASS
    assert "none" not in WORKLOADS_EXPECTED_TO_PASS
    assert set(WORKLOADS_EXPECTED_TO_PASS) == \
        set(ALL_WORKLOADS) - {"lock", "lock-set"}
    assert WORKLOADS_EXPECTED_TO_PASS == REF
