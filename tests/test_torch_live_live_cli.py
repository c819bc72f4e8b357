"""The port's live-etcd run mode, end-to-end through the CLI (the shapes
of the reference's tests/test_live_cli.py; the checks run on the CPU,
``--device cpu``).

`--client-type http --endpoint URL` must run a standard workload
against a real-protocol etcd endpoint with no test code involved
(etcd.clj:246-257: the reference CLI drives a live cluster). Hermetic:
the endpoint is sut/http_gateway.py speaking the v3 JSON-gateway wire
format over real HTTP on a real port.
"""

import json
import os
import threading

import pytest

from jepsen_etcd_tpu_torch.sut.http_gateway import serve


@pytest.fixture()
def gateway():
    srv, state = serve()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_cli_live_register_run(gateway, tmp_path):
    # rate 100: the stats checker reads "unknown" when every cas of a
    # short run loses its value guess
    from jepsen_etcd_tpu_torch.cli import main
    rc = main(["test", "-w", "register", "--client-type", "http",
               "--endpoint", gateway, "--time-limit", "2", "-r", "100",
               "--store", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    # artifacts written like any sim run
    run_dirs = []
    for root, dirs, files in os.walk(tmp_path):
        if "results.json" in files:
            run_dirs.append(root)
    assert len(run_dirs) == 1
    results = json.load(open(os.path.join(run_dirs[0], "results.json")))
    assert results["valid?"] is True
    assert results["workload"]["valid?"] is True
    history = open(os.path.join(run_dirs[0], "history.jsonl")).read()
    assert history.count('"type": "ok"') > 10
    test_json = json.load(open(os.path.join(run_dirs[0], "test.json")))
    assert test_json["client_type"] == "http"
    assert test_json["nodes"] == [gateway]


def test_cli_live_rejects_nemesis(gateway, tmp_path):
    from jepsen_etcd_tpu_torch.cli import main
    with pytest.raises(ValueError, match="no control plane"):
        main(["test", "-w", "register", "--client-type", "http",
              "--endpoint", gateway, "--nemesis", "kill",
              "--time-limit", "2", "--store", str(tmp_path),
              "--device", "cpu"])


def test_live_db_refuses_faults():
    from jepsen_etcd_tpu_torch.db.live import LiveDb
    from jepsen_etcd_tpu_torch.sut.errors import SimError
    db = LiveDb({})
    for fault in ("start", "kill", "pause", "resume", "wipe"):
        with pytest.raises(SimError, match="unsupported"):
            getattr(db, fault)({}, "http://x")


def test_live_db_primaries_returns_leader_endpoint(gateway):
    """primaries() must return the endpoint whose own member id is the
    reported leader (db.clj:38-52), not merely the highest-term
    answerer."""
    from jepsen_etcd_tpu_torch.db.live import LiveDb
    from jepsen_etcd_tpu_torch.runner.wall import WallLoop
    from jepsen_etcd_tpu_torch.runner.sim import set_current_loop

    db = LiveDb({})
    db.members = {gateway}
    loop = WallLoop()
    set_current_loop(loop)
    try:
        assert loop.run_coro(db.primaries({})) == [gateway]
    finally:
        set_current_loop(None)
        loop.shutdown()


# ---- native-gRPC live mode -------------------------------------------------

@pytest.fixture()
def grpc_gateway():
    grpc = pytest.importorskip("grpc")
    from jepsen_etcd_tpu_torch.sut.grpc_gateway import serve_grpc
    srv, state, port = serve_grpc()
    yield f"http://127.0.0.1:{port}"
    srv.stop(0)


def test_cli_live_register_run_grpc(grpc_gateway, tmp_path):
    """--client-type grpc runs the same workload over native gRPC —
    the reference's wire protocol (client.clj:14-68). Rate 100, as
    above."""
    from jepsen_etcd_tpu_torch.cli import main
    rc = main(["test", "-w", "register", "--client-type", "grpc",
               "--endpoint", grpc_gateway, "--time-limit", "2",
               "-r", "100", "--store", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    run_dirs = []
    for root, dirs, files in os.walk(tmp_path):
        if "results.json" in files:
            run_dirs.append(root)
    assert len(run_dirs) == 1
    results = json.load(open(os.path.join(run_dirs[0], "results.json")))
    assert results["valid?"] is True
    assert results["workload"]["valid?"] is True
    history = open(os.path.join(run_dirs[0], "history.jsonl")).read()
    assert history.count('"type": "ok"') > 10
    test_json = json.load(open(os.path.join(run_dirs[0], "test.json")))
    assert test_json["client_type"] == "grpc"
    assert test_json["nodes"] == [grpc_gateway]


# ---- the gateway command ----------------------------------------------------

@pytest.mark.parametrize("wire", ["http", "grpc"])
def test_gateway_command_serves_the_simulated_store(wire, tmp_path):
    """``python -m jepsen_etcd_tpu_torch gateway [--grpc] -p 0`` serves
    the etcd v3 wire over the simulated MVCC store until interrupted;
    the port it bound is in its log line, and the live client of that
    wire round-trips a value through it."""
    import re
    import signal
    import subprocess
    import sys
    import time
    from jepsen_etcd_tpu_torch.runner.sim import set_current_loop
    from jepsen_etcd_tpu_torch.runner.wall import WallLoop
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if wire == "grpc":
        pytest.importorskip("grpc")
    argv = [sys.executable, "-m", "jepsen_etcd_tpu_torch", "gateway",
            "-p", "0"] + (["--grpc"] if wire == "grpc" else [])
    log = open(tmp_path / "gw.log", "w+")
    proc = subprocess.Popen(argv, cwd=repo, stdout=log, stderr=log,
                            env=dict(os.environ, PYTHONPATH=repo))
    try:
        deadline = time.monotonic() + 60
        port = None
        while port is None and time.monotonic() < deadline:
            log.seek(0)
            m = re.search(r"127\.0\.0\.1:(\d+) \(sim store\)", log.read())
            port = int(m.group(1)) if m else None
            assert proc.poll() is None
            time.sleep(0.1)
        assert port, "the gateway never logged its port"
        if wire == "http":
            from jepsen_etcd_tpu_torch.client.etcd_http import \
                HttpEtcdClient as Client
        else:
            from jepsen_etcd_tpu_torch.client.etcd_grpc import \
                GrpcEtcdClient as Client

        async def story():
            c = Client(f"http://127.0.0.1:{port}")
            try:
                await c.put("k", {"v": 1})
                return await c.get("k")
            finally:
                c.close()
        loop = WallLoop()
        set_current_loop(loop)
        try:
            kv = loop.run_coro(story())
        finally:
            set_current_loop(None)
            loop.shutdown()
        assert kv["value"] == {"v": 1} and kv["version"] == 1
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        log.close()
    assert proc.returncode == 0
