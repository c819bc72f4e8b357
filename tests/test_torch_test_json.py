"""The port's run options against the reference's: a stored run's
``test.json`` names every option the reference's names, with the same
values (``device``, ``store_base`` and ``store_dir`` aside), so a run
says which generator epoch produced it; the defaults never raise; the
options whose machinery is still missing raise, naming the ROADMAP item
that brings it; and ``opts_from_args`` fills the reference's keys."""

import contextlib
import io
import json
import os

import pytest

from jepsen_etcd_tpu import cli as ref_cli
from jepsen_etcd_tpu import compose as ref_compose
from jepsen_etcd_tpu_torch import cli, compose
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
    compose._refuse_later_slices(compose.default_opts())
    test = compose.etcd_test({"device": "cpu"})
    assert test["gen_epoch"] == "epoch-v1"
    assert test["inject_stale_reads"] is False


@pytest.mark.parametrize("key,value,item", [
    ("client_type", "http", "A item 8"),
    ("db_mode", "local", "A item 8"),
    ("soak", True, "A item 8"),
    ("soak_windows", 3, "A item 8"),
    ("soak_window_s", 2.0, "A item 8"),
    ("soak_net_faults", ["drop:1.0"], "A item 8"),
    ("net_proxy", True, "A item 8"),
    ("etcd_binary", "fake", "A item 8"),
    ("etcd_data_dir", "/nonexistent", "A item 8"),
    ("etcd_env", {"X": "1"}, "A item 8"),
])
def test_later_slice_options_raise_naming_their_item(key, value, item):
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        compose.etcd_test({key: value, "device": "cpu"})


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
])
def test_opts_from_args_fills_the_references_keys(argv):
    got = cli.opts_from_args(cli.build_parser().parse_args(argv))
    want = ref_cli.opts_from_args(ref_cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
