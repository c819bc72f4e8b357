"""The port's run options against the reference's: a stored run's
``test.json`` names every option the reference's names, with the same
values (``device``, ``store_base`` and ``store_dir`` aside), so a run
says which generator epoch produced it, for simulated, live, local and
soak runs; the defaults never raise; the local control plane's fault
matrix and the refusals of local and soak runs are the reference's,
message for message; and ``opts_from_args`` fills the reference's
keys."""

import contextlib
import io
import json
import os
import shutil
import threading

import pytest

from jepsen_etcd_tpu import cli as ref_cli
from jepsen_etcd_tpu import compose as ref_compose
from jepsen_etcd_tpu.runner import test_runner as ref_runner
from jepsen_etcd_tpu_torch import cli, compose
from jepsen_etcd_tpu_torch.runner import test_runner
from jepsen_etcd_tpu_torch.sut import http_gateway
from test_torch_fixtures import one_torch_thread  # noqa: F401

#: the keys that name where and on what a run ran, not what it ran
WHERE = ("device", "store_base", "store_dir")


def run_main(main, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("{")][-1]
    return rc, json.loads(line)


def stored_test(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "test.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("extra", [[], ["--inject-stale-reads"]],
                         ids=["register", "inject-stale-reads"])
def test_test_json_equals_the_references(tmp_path, extra):
    argv = ["test", "-w", "register", "--time-limit", "5",
            "--seed", "3"] + extra
    rc, want = run_main(ref_cli.main,
                        argv + ["--store", str(tmp_path / "r")])
    got_rc, got = run_main(cli.main, argv + ["--store", str(tmp_path / "p"),
                                             "--device", "cpu"])
    assert rc == got_rc == 0
    ref, port = stored_test(want["dir"]), stored_test(got["dir"])
    assert port["device"] == "cpu"
    assert port["gen_epoch"] == ref["gen_epoch"] == "epoch-v1"
    assert port["inject_stale_reads"] is ref["inject_stale_reads"] \
        is bool(extra)
    for k in WHERE:
        ref.pop(k, None)
        port.pop(k, None)
    assert port == ref


def test_defaults_carry_the_references_and_never_raise():
    got = compose.default_opts()
    want = ref_compose.default_opts()
    assert got.pop("device") is None
    assert got == want
    test = compose.etcd_test({"device": "cpu"})
    assert test["gen_epoch"] == "epoch-v1"
    assert test["inject_stale_reads"] is False


#: local and soak requests the reference refuses, each with its reason
LOCAL = {"client_type": "http", "db_mode": "local", "nodes": ["n1"],
         "etcd_binary": "fake"}
REFUSED = {
    "local-clock": ("compose", dict(LOCAL, nemesis=["clock"])),
    "local-bitflip-wal": ("compose", dict(LOCAL, nemesis=["bitflip-wal"])),
    "local-bitflip-snap": ("compose",
                           dict(LOCAL, nemesis=["bitflip-snap"])),
    "local-truncate-wal": ("compose",
                           dict(LOCAL, nemesis=["truncate-wal"])),
    "local-partition-clock": ("compose",
                              dict(LOCAL, nemesis=["partition", "clock"])),
    "local-all": ("compose", dict(LOCAL, nemesis=cli.parse_nemesis_spec(
        "all"))),
    "soak-direct": ("soak", {"workload": "register", "soak_windows": 1}),
    "soak-etcdctl": ("soak", {"workload": "register",
                              "client_type": "etcdctl",
                              "soak_windows": 1}),
    "soak-net-fault-live": ("soak", {"client_type": "http",
                                     "db_mode": "live", "soak_windows": 1,
                                     "soak_net_faults": ["latency"]}),
    "soak-net-fault-unknown": ("soak", dict(LOCAL, soak_windows=1,
                                            soak_net_faults=["bogus:1"])),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_local_and_soak_refusals_equal_the_references(case):
    entry, opts = REFUSED[case]
    ref, port = {"compose": (ref_compose.etcd_test, compose.etcd_test),
                 "soak": (ref_runner.run_soak, test_runner.run_soak)}[entry]
    with pytest.raises(ValueError) as want:
        ref(dict(opts))
    with pytest.raises(ValueError) as got:
        port(dict(opts, device="cpu"))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("db_mode", ["local", "live", "sim"])
def test_fault_matrix_equals_the_references(db_mode):
    got = compose.fault_matrix(db_mode)
    assert got == ref_compose.fault_matrix(db_mode)
    assert compose.LOCAL_FAULTS == ref_compose.LOCAL_FAULTS
    assert compose.LOCAL_FAULT_REFUSALS == ref_compose.LOCAL_FAULT_REFUSALS
    if db_mode == "local":
        assert {f for f, r in got.items() if r["supported"]} == \
            compose.LOCAL_FAULTS


def run_lines(main, argv) -> tuple:
    """The exit code and every JSON line a command printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture()
def gateway():
    srv, _ = http_gateway.serve()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("mode", ["live", "local", "soak"])
def test_live_test_json_equals_the_references(tmp_path, gateway, mode):
    """Both packages run the same live, local or soak command line (the
    reference first); each starts on a fresh store: a new gateway state,
    or the local node's data dir removed. Each run's workload is valid
    and its exit code follows its verdict: a 1 s wall-clock run may see
    no ok CAS, and then the stats checker says "unknown" in either
    package."""
    data = str(tmp_path / "cluster")
    argv = ["test", "-w", "register", "--time-limit", "1", "-r", "50",
            "-c", "2", "--seed", "5", "--client-type", "http"]
    if mode == "live":
        argv += ["--endpoint",
                 f"http://127.0.0.1:{gateway.server_address[1]}"]
    else:
        argv += ["--db", "local", "--etcd-binary", "fake", "--nodes", "n1",
                 "--etcd-data-dir", data]
    if mode == "soak":
        argv += ["--soak", "--soak-windows", "1", "--soak-window-s", "1"]
    stored = []
    for main, store, extra in ((ref_cli.main, "r", []),
                               (cli.main, "p", ["--device", "cpu"])):
        gateway.RequestHandlerClass.state = http_gateway.GatewayState()
        shutil.rmtree(data, ignore_errors=True)
        rc, lines = run_lines(main, argv + ["--store", str(tmp_path / store)]
                              + extra)
        run_dir = [ln for ln in lines if "dir" in ln][-1]["dir"]
        with open(os.path.join(run_dir, "results.json")) as f:
            res = json.load(f)
        assert res["workload"]["valid?"] is True, lines
        assert all(v.get("valid?", True) is True for k, v in res.items()
                   if isinstance(v, dict) and k != "stats"), res
        assert rc == (0 if res["valid?"] is True else 1), lines
        stored.append(stored_test(run_dir))
    ref, port = stored
    assert port["device"] == "cpu"
    assert port["client_type"] == "http"
    assert port["db_mode"] == ("live" if mode == "live" else "local")
    assert port["name"].endswith("-soak-w0") is (mode == "soak")
    # a soak window streams its check: ``_stream`` holds the packs of
    # the window's own history, which a wall-clock run does not repeat
    for k in WHERE + ("_stream",):
        ref.pop(k, None)
        port.pop(k, None)
    assert port == ref


@pytest.mark.parametrize("key,value", [
    ("inject_stale_reads", True), ("gen_epoch", "epoch-v2"),
    ("nem_schedule", [[1_000_000_000, "kill", 500_000_000]]),
    ("nem_partition_shape", "primaries"), ("nem_latency_ms", 32.0),
    ("nem_drop_prob", 0.05), ("key_offset", 7),
])
def test_options_of_the_batched_generator_compose(key, value):
    """The options the batched generator reads (and the register
    workload's key offset) are accepted and carried into the test."""
    test = compose.etcd_test({key: value, "device": "cpu",
                              "nemesis": ["kill"]})
    assert test[key] == value


@pytest.mark.parametrize("argv", [
    ["test"],
    ["test", "--inject-stale-reads", "--seed", "3"],
    ["test-all", "--inject-stale-reads", "--nemesis", "kill"],
    ["campaign", "--inject-stale-reads", "-w", "register",
     "--nodes", "n1,n2,n3", "-c", "2n", "--time-limit", "1"],
    ["campaign", "--guided", "10", "--gen-epoch", "epoch-v2",
     "--master-seed", "7", "--pool", "0", "--no-service", "--no-live"],
    ["test", "--client-type", "http", "--endpoint",
     "http://127.0.0.1:2379,http://127.0.0.1:2380", "-c", "2n"],
    ["test", "--client-type", "grpc", "--db", "local", "--etcd-binary",
     "fake", "--etcd-data-dir", "/tmp/d", "--nodes", "n1,n2,n3",
     "--nemesis", "partition", "--net-proxy"],
    ["test", "--client-type", "http", "--db", "local", "--soak",
     "--soak-windows", "3", "--soak-window-s", "2", "--soak-net-fault",
     "drop:0.5", "--soak-net-fault", "latency"],
    ["campaign", "--client-type", "http", "--endpoint",
     "http://127.0.0.1:2379", "--pool", "0"],
])
def test_opts_from_args_fills_the_references_keys(argv):
    got = cli.opts_from_args(cli.build_parser().parse_args(argv))
    want = ref_cli.opts_from_args(ref_cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
