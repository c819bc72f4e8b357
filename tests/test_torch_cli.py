"""The port's command line against the JAX package's: ``python -m
jepsen_etcd_tpu_torch test ... --device cpu`` prints the reference
CLI's verdict and op count and writes the same ``history.jsonl``, with
the run's other artifacts beside it; its options parse to the
reference's; ``test-all`` sweeps; and with no ``--device`` and no card
the command fails instead of moving to the CPU."""

import json
import os
import subprocess
import sys

import pytest

from jepsen_etcd_tpu import cli as ref_cli
from jepsen_etcd_tpu_torch import cli
from test_torch_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = ["--time-limit", "6", "-r", "50", "--ops-per-key", "30",
         "--seed", "7"]

ARTIFACTS = ("history.jsonl", "results.json", "test.json",
             "timeline.html", "n1/etcd.log")


def port_cli(argv, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "jepsen_etcd_tpu_torch"] + argv, cwd=REPO,
        env=env, capture_output=True, text=True, timeout=timeout)


def last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def test_cli_run_equals_the_references(tmp_path, capsys):
    argv = ["test", "-w", "register"] + SMALL
    rc = ref_cli.main(argv + ["--store", str(tmp_path / "r")])
    want = last_json(capsys.readouterr().out)
    got = port_cli(argv + ["--device", "cpu",
                           "--store", str(tmp_path / "p")])
    assert got.returncode == rc == 0, got.stderr[-2000:]
    line = last_json(got.stdout)
    assert (line["valid?"], line["ops"]) == (want["valid?"], want["ops"])
    assert line["valid?"] is True and line["ops"] > 100
    assert line["test"] == want["test"] == "etcd-register"
    for f in ARTIFACTS:
        assert os.path.exists(os.path.join(line["dir"], f)), f
    with open(os.path.join(want["dir"], "history.jsonl"), "rb") as f:
        ref_bytes = f.read()
    with open(os.path.join(line["dir"], "history.jsonl"), "rb") as f:
        assert f.read() == ref_bytes
    with open(os.path.join(line["dir"], "test.json")) as f:
        assert json.load(f)["device"] == "cpu"


def test_cli_without_a_card_fails(tmp_path):
    """No ``--device`` and no visible card: the command raises."""
    got = port_cli(["test", "-w", "none", "--time-limit", "1",
                    "--store", str(tmp_path)],
                   env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode != 0
    assert "no CUDA device" in got.stderr
    assert not os.path.exists(os.path.join(str(tmp_path), "etcd-none"))


@pytest.mark.parametrize("argv", [
    ["test"],
    ["test", "-w", "watch", "-c", "4n", "--nemesis", "kill,partition",
     "--serializable", "--client-type", "etcdctl", "--seed", "3"],
    ["test-all", "--nodes", "n1,n2,n3", "-c", "7", "--nemesis", "all",
     "--lazyfs", "--tcpdump", "--no-telemetry"],
    ["test", "-w", "append", "--snapshot-count", "50",
     "--unsafe-no-fsync", "--corrupt-check", "--rate", "10",
     "--time-limit", "2.5", "--nemesis-interval", "3"],
])
def test_options_parse_to_the_references(argv):
    got = cli.opts_from_args(cli.build_parser().parse_args(argv))
    want = ref_cli.opts_from_args(ref_cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == {k: want[k] for k in got}


def test_test_all_matrix_is_the_references_filtered():
    """The filter is gone: every workload of the reference's sweep is
    ported, so the matrix is the reference's."""
    args = cli.build_parser().parse_args(["test-all"])
    wls, nemeses = cli.test_all_matrix(args)
    assert nemeses == ref_cli.ALL_NEMESES
    assert (wls, nemeses) == ref_cli.test_all_matrix(
        ref_cli.build_parser().parse_args(["test-all"]))
    assert len(wls) == 12
    argv = ["test-all", "--only-workloads-expected-to-pass", "--nemesis",
            "kill"]
    got = cli.test_all_matrix(cli.build_parser().parse_args(argv))
    assert got == ref_cli.test_all_matrix(
        ref_cli.build_parser().parse_args(argv))
    assert got[1] == [["kill"]] and "lock" not in got[0]


def test_test_all_sweeps(tmp_path, capsys):
    rc = cli.main(["test-all", "-w", "wr", "--nemesis", "kill",
                   "--time-limit", "3", "-r", "50", "--device", "cpu",
                   "--store", str(tmp_path)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 0
    assert lines[0]["test"] == "etcd-wr-kill" and lines[0]["valid?"]
    assert lines[-1] == {"failures": []}


#: the reference's commands that read the store, and command lines of
#: each
STORE_READER_ARGV = {
    "serve": [["serve"], ["serve", "--store", "s", "-p", "0", "-b",
                          "0.0.0.0"]],
    "store": [["store", "index"], ["store", "index", "--rebuild",
                                   "--store", "s"],
              ["store", "compact", "--keep", "4", "--dry-run"]],
}


@pytest.mark.parametrize("command", ["serve", "store"])
def test_later_commands_are_not_registered(command):
    """The store readers' commands came last: they are registered now
    and parse as the reference's do (a bare ``store`` wants its action
    in both)."""
    for argv in STORE_READER_ARGV[command]:
        assert vars(cli.build_parser().parse_args(argv)) == \
            vars(ref_cli.build_parser().parse_args(argv))
    if command == "store":
        for parser in (cli.build_parser(), ref_cli.build_parser()):
            with pytest.raises(SystemExit):
                parser.parse_args(["store"])


@pytest.mark.parametrize("argv", [["gateway"],
                                  ["gateway", "-p", "0", "--grpc"]])
def test_gateway_parses_as_the_references(argv):
    """``gateway`` came with the live side and parses as the
    reference's does."""
    got = cli.build_parser().parse_args(argv)
    assert vars(got) == vars(ref_cli.build_parser().parse_args(argv))
