"""The port's ``test`` entry point on the simulated cluster against the
JAX package's: ``run_test(etcd_test(opts))`` on the same opts gives the
same history bytes, the same verdict dicts and the same timeline for
register (clean and under kill + partition), none, watch, append and
wr, at the e2e suite's small size (``tests/test_e2e.py:10-14``). The
port runs with ``device="cpu"``: its kernels' plain PyTorch versions.
With ``force_kernel`` every key of the register workload goes to the
wave kernel's batched launch (the reference's Pallas batch in interpret
mode). The live side refuses what the reference refuses, with the
reference's messages, the client factory builds the live clients, and
without a card the port never moves to the CPU on its own."""

import json
import os

import pytest
import torch

from jepsen_etcd_tpu import compose as ref_compose
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import test_runner as ref_runner
from jepsen_etcd_tpu.workloads import ALL_WORKLOADS as REF_ALL
from jepsen_etcd_tpu.workloads import WORKLOADS_EXPECTED_TO_PASS as REF_PASS
from jepsen_etcd_tpu.workloads import workloads as ref_workloads
from jepsen_etcd_tpu_torch import client, compose
from jepsen_etcd_tpu_torch.runner import test_runner
from jepsen_etcd_tpu_torch.workloads import (ALL_WORKLOADS,
                                             WORKLOADS_EXPECTED_TO_PASS,
                                             workloads)
from test_torch_fixtures import one_torch_thread  # noqa: F401

BASE = {"time_limit": 6, "rate": 50, "ops_per_key": 30, "seed": 7}

CASES = {
    "register": {"workload": "register"},
    "register-kill-partition": {"workload": "register",
                                "nemesis": ["kill", "partition"]},
    "none": {"workload": "none", "time_limit": 3},
    "watch": {"workload": "watch"},
    "append": {"workload": "append"},
    "wr": {"workload": "wr"},
}

#: result fields that read the host's wall clock, dropped before the
#: dicts are compared: the run's telemetry summary (span seconds)
WALL_CLOCK_FIELDS = ("telemetry",)

#: the checker keys of the composed stack (compose.py), compared one by
#: one; the timeline's dict names its file, compared under the store
CHECKER_KEYS = ("perf", "stats", "exceptions", "crash", "clock",
                "workload")


def run_ref(store, **opts):
    o = dict(BASE, store_base=str(store))
    o.update(opts)
    return ref_runner.run_test(ref_compose.etcd_test(o))


def run_port(store, **opts):
    o = dict(BASE, store_base=str(store), device="cpu")
    o.update(opts)
    return test_runner.run_test(compose.etcd_test(o))


def as_json(x):
    return json.loads(json.dumps(x, default=repr, sort_keys=True))


def comparable(out, store) -> dict:
    res = {k: v for k, v in out["results"].items()
           if k not in WALL_CLOCK_FIELDS}
    tl = dict(res["timeline"])
    tl["file"] = os.path.relpath(tl["file"], str(store))
    res["timeline"] = tl
    return as_json(res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case run once by each package, on demand."""
    done = {}

    def get(case):
        if case not in done:
            ref_store = tmp_path_factory.mktemp("ref")
            port_store = tmp_path_factory.mktemp("port")
            done[case] = (run_ref(ref_store, **CASES[case]), ref_store,
                          run_port(port_store, **CASES[case]), port_store)
        return done[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_history_bytes_equal_the_references(runs, case):
    ref, _, port, _ = runs(case)
    assert port["history"].to_jsonl() == ref["history"].to_jsonl()
    assert port["valid?"] is ref["valid?"] is True
    if case != "none":
        assert len(port["history"]) > 100


@pytest.mark.parametrize("case", list(CASES))
def test_verdict_dicts_equal_the_references(runs, case):
    ref, ref_store, port, port_store = runs(case)
    want, got = comparable(ref, ref_store), comparable(port, port_store)
    assert set(got) == set(want)
    for key in CHECKER_KEYS + ("timeline", "valid?"):
        assert got[key] == want[key], key
    assert got == want
    assert port["sim-seconds"] == ref["sim-seconds"]


@pytest.mark.parametrize("case", list(CASES))
def test_timeline_bytes_equal_the_references(runs, case):
    ref, _, port, _ = runs(case)
    with open(os.path.join(ref["dir"], "timeline.html")) as f:
        want = f.read()
    with open(os.path.join(port["dir"], "timeline.html")) as f:
        assert f.read() == want


@pytest.mark.parametrize("case", ["register", "watch"])
def test_history_filters_equal_the_references(runs, case):
    ref, _, port, _ = runs(case)
    for name, args in (("invokes", ()), ("nemesis_ops", ()),
                       ("client_ops", ()), ("remove_f", ({"write"},))):
        got = getattr(port["history"], name)(*args)
        want = getattr(ref["history"], name)(*args)
        assert got.to_jsonl() == want.to_jsonl(), name


def test_kernel_route_dicts_equal_the_references(tmp_path, monkeypatch):
    """force_kernel: every key through the wave kernel's batched launch,
    its dict equal to the reference's, engine, waves and peak-frontier
    included (the reference's Pallas batch runs in interpret mode)."""
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    ref = run_ref(tmp_path / "r", workload="register", force_kernel=True)
    port = run_port(tmp_path / "p", workload="register", force_kernel=True)
    assert port["history"].to_jsonl() == ref["history"].to_jsonl()
    got = port["results"]["workload"]["results"]
    want = ref["results"]["workload"]["results"]
    assert list(got) == list(want) and len(got) > 5
    for k in want:
        assert got[k] == want[k], k
        assert got[k]["linear"]["engine"] == "mxu-wave"
        assert {"waves", "peak-frontier"} <= set(got[k]["linear"])
    assert port["valid?"] is True


def test_stale_reads_fail_on_the_same_keys(tmp_path):
    """Serializable reads are node-local and stale: not linearizable, in
    both packages, on the same keys."""
    opts = {"workload": "register", "serializable": True, "rate": 100,
            "time_limit": 8}
    ref = run_ref(tmp_path / "r", **opts)
    port = run_port(tmp_path / "p", **opts)
    assert port["valid?"] is ref["valid?"] is False

    def failing(out):
        return sorted(k for k, r in out["results"]["workload"][
            "results"].items() if r["valid?"] is False)
    assert failing(port) == failing(ref) != []
    assert as_json(port["results"]["workload"]) == \
        as_json(ref["results"]["workload"])


def test_same_seed_same_history(tmp_path):
    a = run_port(tmp_path, workload="register", seed=42)
    b = run_port(tmp_path, workload="register", seed=42)
    assert a["history"].to_jsonl() == b["history"].to_jsonl()
    assert a["dir"] != b["dir"]


def test_workload_registry_is_the_ported_subset():
    """Since the set, lock and MVCC workloads came over, the ported
    subset is the whole of the reference's registry."""
    names = set(workloads())
    assert names == set(ref_workloads()) and len(names) == 13
    assert ALL_WORKLOADS == [w for w in REF_ALL if w in names] == REF_ALL
    assert WORKLOADS_EXPECTED_TO_PASS == [w for w in REF_PASS
                                          if w in names] == REF_PASS


@pytest.mark.parametrize("workload", ["register", "none", "watch",
                                      "append", "wr", "set", "lock",
                                      "lock-lease", "lock-set",
                                      "lock-etcd-set", "register-stale",
                                      "ranges", "compact-watch"])
def test_no_card_raises_unless_cpu(monkeypatch, workload):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compose.etcd_test({"workload": workload, "device": device})
    test = compose.etcd_test({"workload": workload, "device": "cpu"})
    assert test["device"] == "cpu" and test["db_mode"] == "sim"


#: live-side requests the reference refuses while composing a test
REFUSED = {
    "live-http-kill": {"client_type": "http", "nemesis": ["kill"]},
    "live-grpc-partition-pause": {"client_type": "grpc",
                                  "nemesis": ["partition", "pause"]},
    "local-direct": {"db_mode": "local"},
    "live-direct": {"db_mode": "live"},
    "local-etcdctl": {"db_mode": "local", "client_type": "etcdctl"},
    "live-etcdctl": {"db_mode": "live", "client_type": "etcdctl"},
    "sim-grpc": {"db_mode": "sim", "client_type": "grpc"},
    "sim-http": {"db_mode": "sim", "client_type": "http"},
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_live_refusals_equal_the_references(case):
    with pytest.raises(ValueError) as want:
        ref_compose.etcd_test(dict(REFUSED[case]))
    with pytest.raises(ValueError) as got:
        compose.etcd_test(dict(REFUSED[case], device="cpu"))
    assert str(got.value) == str(want.value)


class _LocalDbStub:
    def client_url(self, node):
        return {"n1": "http://127.0.0.1:1"}[node]


@pytest.mark.parametrize("ctype", ["http", "grpc"])
def test_client_factory_builds_the_live_clients(ctype):
    """http and grpc build the port's live clients: in live mode the
    node is its endpoint URL, in local mode the control plane maps the
    node's name to its client URL; histories name the node."""
    from jepsen_etcd_tpu_torch.client.etcd_grpc import GrpcEtcdClient
    from jepsen_etcd_tpu_torch.client.etcd_http import HttpEtcdClient
    cls = {"http": HttpEtcdClient, "grpc": GrpcEtcdClient}[ctype]
    live = client.client({"client_type": ctype}, "http://127.0.0.1:2")
    local = client.client({"client_type": ctype, "db_mode": "local",
                           "db": _LocalDbStub()}, "n1")
    try:
        assert type(live) is cls and type(local) is cls
        assert live.node == "http://127.0.0.1:2" and local.node == "n1"
        assert local.endpoint.endswith("127.0.0.1:1")
    finally:
        live.close()
        local.close()
