"""The port's multi-host fleet (``runner/host_agent.py`` and the TCP
checker service), on the CPU, on the shapes of
``tests/test_host_fleet.py``: a campaign fanned over two worker-agent
processes of this package (``python -m jepsen_etcd_tpu_torch
worker-agent``) over loopback TCP, every run checked through the
campaign's service with the campaign's token, the shipped == submitted
ledger balanced per host and in total, and every stored verdict equal
to in-process re-checks by the port and the reference; a campaign whose
service starts late heals; agent deaths re-queue and strand to inline
runs; a fleet of none runs inline; a wrong token never joins. The
reference's net-proxy case is tests/test_torch_live_fleet_net.py. The
service runs on CPU lanes with the wave kernel's gate open
(as in ``tests/test_torch_campaign.py``); the agents check nothing
themselves."""

import json
import os
import threading

import pytest
import torch

from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.runner import checker_service as svc_mod
from jepsen_etcd_tpu_torch.runner import host_agent, transport
from jepsen_etcd_tpu_torch.runner.campaign import campaign_specs, run_campaign
from jepsen_etcd_tpu_torch.runner.host_agent import HostAgentPool
from jepsen_etcd_tpu_torch.runner.telemetry import Telemetry
from test_torch_campaign import (recheck_port, recheck_reference,
                                 stored_view)
from test_torch_checker_service_lanes import sock_path
from test_torch_fixtures import one_torch_thread  # noqa: F401

BASE = {"time_limit": 1, "rate": 100.0, "force_kernel": True,
        "nodes": ["n1", "n2", "n3"], "device": "cpu"}


@pytest.fixture
def fleet_lanes(monkeypatch):
    """Two CPU lanes for the campaign's service, the wave kernel's gate
    open, the reference's kernel on for its re-checks."""
    lanes = [torch.device("cpu")] * 2
    monkeypatch.setattr(
        wgl_mxu, "batch_lanes",
        lambda device=None: [torch.device(device)] if device is not None
        else list(lanes))
    monkeypatch.setattr(wgl, "_b1_first", lambda device: True)
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    yield
    svc_mod.reset_clients()


def assert_cross_host_ledger(summary, hosts):
    rows = summary["runs"]
    ctr = summary["telemetry"]["counters"]
    by_host = summary["hosts"]
    assert by_host is not None and set(by_host) == set(hosts), by_host
    assert {r["host"] for r in rows} == set(hosts)
    submitted = ctr.get("service.submitted", 0)
    assert submitted >= len(rows), ctr
    total = 0
    for h in hosts:
        st = by_host[h]
        assert st["runs"] == sum(1 for r in rows if r["host"] == h)
        assert st["shipped"] == sum(r["service_shipped"] for r in rows
                                    if r["host"] == h)
        assert st["shipped"] == ctr.get("service.host_submitted." + h), \
            (h, st, ctr)
        total += st["shipped"]
    assert total == submitted, (total, ctr)
    assert not ctr.get("service.fallback"), ctr


def test_agents_spawn_this_package():
    argv = host_agent.agent_argv("tcp://127.0.0.1:1", "hostA")
    assert argv[1:4] == ["-m", "jepsen_etcd_tpu_torch", "worker-agent"]
    assert argv[-4:] == ["--connect", "tcp://127.0.0.1:1", "--host",
                         "hostA"]


def test_two_host_campaign_cross_host_ledger(tmp_path, fleet_lanes):
    specs = campaign_specs(BASE, ["register"], [[]], runs_per_cell=8,
                           seed0=200)
    summary = run_campaign(specs, pool=0, service=True,
                           service_tick_s=0.05, hosts=["hostA", "hostB"],
                           store_base=str(tmp_path), name="fleet")
    assert summary["valid?"] is True, summary["failures"]
    rows = summary["runs"]
    assert len(rows) == 8
    assert all(r["status"] == "done" and r["valid"] is True
               for r in rows)
    assert summary["telemetry"]["counters"].get("campaign.hosts") == 2
    assert all(summary["hosts"][h]["runs"] >= 1
               for h in ("hostA", "hostB")), summary["hosts"]
    assert summary["agent_requeues"] == 0
    assert_cross_host_ledger(summary, ["hostA", "hostB"])
    for r in rows:
        got = stored_view(r["dir"])
        assert got == recheck_port(r["dir"]), r["dir"]
        assert got == recheck_reference(r["dir"]), r["dir"]


def test_degraded_start_heals_mid_campaign(tmp_path, monkeypatch,
                                           fleet_lanes):
    """A campaign whose configured service is down checks in-process,
    then ships again once the service is up; the ledger balances and
    every verdict equals a re-check."""
    monkeypatch.setattr(svc_mod, "RETRY_BASE_S", 0.02)
    monkeypatch.setattr(svc_mod, "RETRY_CAP_S", 0.05)
    svc_mod.reset_clients()
    path = sock_path(tmp_path)
    specs = campaign_specs(dict(BASE, checker_service=path), ["register"],
                           [[]], runs_per_cell=6, seed0=100)
    state = {"svc": None}
    lock = threading.Lock()

    def heal_after_two(row):
        with lock:
            if state["svc"] is None and row["index"] >= 1:
                state["svc"] = svc_mod.CheckerService(
                    path=path, tick_s=0.01).start()

    try:
        summary = run_campaign(specs, pool=0, service=False,
                               store_base=str(tmp_path), name="heal",
                               on_row=heal_after_two)
    finally:
        if state["svc"] is not None:
            state["svc"].close()
        svc_mod.reset_clients()
    assert state["svc"] is not None
    assert summary["valid?"] is True, summary["failures"]
    rows = summary["runs"]
    assert rows[0]["service_shipped"] == 0
    assert rows[0]["service_fallbacks"] >= 1
    assert any(r["service_shipped"] > 0 for r in rows[2:]), rows
    svc_ctr = state["svc"].stats()["counters"]
    assert sum(r["service_shipped"] for r in rows) == \
        svc_ctr.get("service.submitted", 0)
    for r in rows:
        assert stored_view(r["dir"]) == recheck_port(r["dir"]), r["dir"]


def _fake_agent(endpoint, host, token, died):
    """An agent that registers, takes one run frame and dies mid-run."""
    sock = transport.connect(endpoint, timeout=5.0)
    try:
        transport.send_preamble(sock, host)
        transport.send_frame(sock, json.dumps(
            {"op": "register", "host": host, "token": token}).encode())
        reader = transport.FrameReader(sock)
        assert json.loads(reader.recv_frame()).get("ok")
        assert json.loads(reader.recv_frame()).get("op") == "run"
    finally:
        sock.close()
        died.set()


def _spec(tmp_path, seed):
    return {"index": 0,
            "opts": {"workload": "register", "time_limit": 1,
                     "rate": 100.0, "seed": seed,
                     "nodes": ["n1", "n2", "n3"], "device": "cpu",
                     "store_base": str(tmp_path)}}


def test_agent_death_requeues_then_runs_inline(tmp_path):
    tel = Telemetry()
    pool = HostAgentPool(token="tok", tel=tel, idle_timeout=2.0).start()
    died = threading.Event()
    t = threading.Thread(target=_fake_agent,
                         args=(pool.endpoint, "flaky", "tok", died))
    t.start()
    try:
        assert pool.wait_ready(1, timeout=10.0) == 1
        assert pool.hosts() == ["flaky"]
        rows = []
        pool.run([_spec(tmp_path, 5)], rows.append)
        t.join(timeout=10.0)
        assert died.is_set() and pool.requeues >= 1
        assert len(rows) == 1
        assert rows[0]["status"] == "done" and rows[0]["valid"] is True
        assert tel.summary()["counters"].get(
            "campaign.agent_requeues", 0) >= 1
    finally:
        pool.close()


def test_agent_pool_zero_agents_runs_inline(tmp_path):
    pool = HostAgentPool().start()
    try:
        rows = []
        pool.run([_spec(tmp_path, 9)], rows.append)
        assert len(rows) == 1 and rows[0]["status"] == "done"
    finally:
        pool.close()


def test_agent_pool_rejects_bad_token():
    pool = HostAgentPool(token="right").start()
    try:
        sock = transport.connect(pool.endpoint, timeout=5.0)
        try:
            transport.send_preamble(sock, "evil")
            transport.send_frame(sock, json.dumps(
                {"op": "register", "host": "evil",
                 "token": "wrong"}).encode())
            reader = transport.FrameReader(sock)
            sock.settimeout(5.0)
            assert json.loads(reader.recv_frame()).get("error")
        finally:
            sock.close()
        assert pool.wait_ready(1, timeout=0.5) == 0
        assert pool.hosts() == []
    finally:
        pool.close()


@pytest.mark.slow
def test_three_host_soak(tmp_path, fleet_lanes):
    """3 worker-agent processes, 24 runs: the cross-host ledger
    balances and every verdict equals a re-check."""
    specs = campaign_specs(BASE, ["register"], [[], ["kill"]],
                           runs_per_cell=12, seed0=600)
    hosts = ["hostA", "hostB", "hostC"]
    summary = run_campaign(specs, pool=0, service=True,
                           service_tick_s=0.05, hosts=hosts,
                           store_base=str(tmp_path), name="soak")
    assert summary["valid?"] is True, summary["failures"]
    assert len(summary["runs"]) == 24
    assert_cross_host_ledger(summary, hosts)
    for r in summary["runs"]:
        assert stored_view(r["dir"]) == recheck_port(r["dir"]), r["dir"]
