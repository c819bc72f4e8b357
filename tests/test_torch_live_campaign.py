"""Live specs in the port's campaign runner: a live spec never takes the
batched generator (its history is observed, not generated, as in the
reference), so it goes to the pool of spawned workers and runs there
against its gateway, beside a simulated epoch-v2 spec that the batched
generator serves."""

import os
import threading

import pytest

from jepsen_etcd_tpu.runner import campaign as ref_campaign
from jepsen_etcd_tpu_torch.runner import campaign
from jepsen_etcd_tpu_torch.sut.http_gateway import serve
from test_torch_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture()
def gateway():
    srv, _ = serve()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("opts", [
    {"client_type": "http", "nodes": ["http://127.0.0.1:1"]},
    {"client_type": "grpc", "nodes": ["http://127.0.0.1:1"]},
    {"client_type": "http", "db_mode": "local", "nodes": ["n1"]},
    {"client_type": "http", "db_mode": "local", "soak": True},
])
def test_live_specs_leave_the_batched_generator(opts):
    spec = dict({"workload": "register", "gen_epoch": "epoch-v2"}, **opts)
    assert campaign._batchable(dict(spec)) is False
    assert ref_campaign._batchable(dict(spec)) is False


def test_pooled_live_spec_runs(tmp_path, gateway):
    # rate 150: the stats checker reads "unknown" when every cas of a
    # short run loses its value guess
    base = {"workload": "register", "gen_epoch": "epoch-v2",
            "time_limit": 2, "rate": 150.0, "concurrency": 2,
            "device": "cpu", "no_telemetry": True}
    specs = [{"opts": dict(base, nodes=["n1", "n2", "n3"], seed=1)},
             {"opts": dict(base, client_type="http", nodes=[gateway],
                           seed=2)}]
    summary = campaign.run_campaign(specs, pool=1, service=False,
                                    store_base=str(tmp_path),
                                    name="live", live=False)
    rows = summary["runs"]
    assert summary["valid?"] is True, [(r["valid"], r.get("error"))
                                       for r in rows]
    assert [r["status"] for r in rows] == ["done", "done"]
    assert [r["gen-epoch"] for r in rows] == ["epoch-v2", None]
    assert rows[1]["ops"] > 10
    for r in rows:
        assert os.path.isfile(os.path.join(r["dir"], "history.jsonl"))
