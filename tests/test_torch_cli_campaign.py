"""The port's ``campaign``, ``replay``, ``worker-agent`` and ``tel``
commands against the JAX package's: their options parse to the
reference's; a small campaign prints the reference's rows and summary
(paths and timing aside); and with no card, ``campaign`` and ``replay``
fail before any run, pool or service starts."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from jepsen_etcd_tpu import cli as ref_cli
from jepsen_etcd_tpu_torch import cli
from test_torch_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: printed fields read off a host clock or naming a path
TIMING = ("dir", "wall_s")


@pytest.mark.parametrize("argv", [
    ["campaign"],
    ["campaign", "-w", "register", "--nemesis", "kill", "--pool", "2",
     "--no-service", "--no-live", "--service-tick", "0.1",
     "--campaign-name", "c", "--gen-epoch", "epoch-v3", "--hosts", "2",
     "--force-kernel", "--test-count", "3", "--inject-stale-reads"],
    ["campaign", "--guided", "12", "--master-seed", "7", "--corpus-in",
     "a.json", "--corpus-out", "b.json", "--gen-epoch", "epoch-v2"],
    ["tel", "a", "b", "--diff", "--json"],
    ["tel", "d", "--ledger", "--no-index"],
    ["tel", "d", "--coverage"],
    ["tel", "d", "--corpus"],
    ["replay", "store/x/shrink.json"],
    ["worker-agent", "--connect", "tcp://127.0.0.1:9", "--host", "hostA",
     "--token", "t"],
])
def test_new_commands_parse_to_the_references(argv):
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(ref_cli.build_parser().parse_args(argv))
    if argv[0] in ("campaign", "replay"):
        assert got.pop("device") == "cuda"
    assert got == {k: want[k] for k in got}
    # the reference's extra options are the live side's (A8)
    assert set(want) - set(got) <= {"endpoint", "db", "etcd_binary",
                                    "etcd_data_dir", "net_proxy",
                                    "stream", "stream_chunk_ops", "soak",
                                    "soak_windows", "soak_window_s",
                                    "soak_net_fault", "staleness_bound_s",
                                    "lease_ttl_ms", "compact_keep"}


def printed(main, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    return rc, [{k: v for k, v in ln.items() if k not in TIMING}
                for ln in lines]


def test_campaign_command_prints_the_references(tmp_path):
    argv = ["campaign", "-w", "register", "--nodes", "n1,n2,n3",
            "--nemesis", "kill", "--time-limit", "1", "--rate", "100",
            "--test-count", "2", "--seed", "7", "--pool", "0",
            "--no-service", "--no-live", "--gen-epoch", "epoch-v2"]
    rc, want = printed(ref_cli.main, argv + ["--store",
                                             str(tmp_path / "r")])
    got_rc, got = printed(cli.main, argv + ["--store", str(tmp_path / "p"),
                                            "--device", "cpu"])
    assert rc == got_rc == 0
    assert got == want
    assert got[-1]["runs"] == 2 and got[-1]["valid?"] is True


def port_cli(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "jepsen_etcd_tpu_torch"] + argv, cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)


def test_campaign_without_a_card_fails_before_spawning(tmp_path):
    got = port_cli(["campaign", "-w", "register", "--time-limit", "1",
                    "--test-count", "4", "--pool", "4", "--store",
                    str(tmp_path)], tmp_path)
    assert got.returncode != 0
    assert "no CUDA device" in got.stderr
    assert os.listdir(str(tmp_path)) == []
    assert "SpawnProcess" not in got.stderr


def test_replay_without_a_card_fails(tmp_path):
    art = tmp_path / "shrink.json"
    art.write_text(json.dumps({"config": {}, "checker_opts": {},
                               "seed": 0, "signature": "x"}))
    got = port_cli(["replay", str(art)], tmp_path)
    assert got.returncode != 0
    assert "no CUDA device" in got.stderr
