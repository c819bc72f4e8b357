"""The port's checker fleet under its own faults, the shape of the
reference's ``test_fleet_survives_net_faults_through_proxy``
(tests/test_host_fleet.py): host->service traffic routed through the
port's proxy plane (``net/``) under a partition, latency with jitter,
slow-close and a lossy link. Every check either succeeds with the
verdicts of an in-process check or degrades to None (the caller's local
fallback) quickly, and the client re-promotes after the heal. The
service runs on a CPU lane."""

import time

import torch

from jepsen_etcd_tpu_torch.net.plane import NetPlane
from jepsen_etcd_tpu_torch.ops import wgl
from jepsen_etcd_tpu_torch.runner import checker_service as svc_mod
from jepsen_etcd_tpu_torch.runner import telemetry, transport
from jepsen_etcd_tpu_torch.runner.telemetry import Telemetry
from test_torch_checker_service import port_packs, view
from test_torch_checker_service_lanes import use_lanes
from test_torch_fixtures import one_torch_thread  # noqa: F401


def test_fleet_survives_net_faults_through_proxy(monkeypatch):
    use_lanes(monkeypatch, [torch.device("cpu")])
    monkeypatch.setattr(svc_mod, "RETRY_BASE_S", 0.05)
    monkeypatch.setattr(svc_mod, "RETRY_CAP_S", 0.2)
    svc = svc_mod.CheckerService(tick_s=0.01, tcp=True,
                                 auth_token="tok",
                                 heartbeat_s=0.25).start()
    plane = NetPlane(seed=3)
    tel = Telemetry()
    prev = telemetry.current()
    telemetry.set_current(tel)
    client = None
    try:
        _, port = transport.parse_tcp(svc.tcp_endpoint)
        ep = plane.front_service(port)
        # idle_timeout >> heartbeat_s: silence means dead, not slow
        client = svc_mod.CheckerClient(ep, token="tok", host="hostB",
                                       connect_timeout=2.0,
                                       idle_timeout=1.5, timeout=60.0)
        packs = port_packs(301, 3, info_rate=0.2)
        want = [view(wgl.check_packed(p, device="cpu")) for p in packs]

        def check_ok():
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                outs = client.check(packs)
                if outs is not None:
                    return outs
                time.sleep(0.05)  # cooldown armed: wait it out
            raise AssertionError("client never re-promoted")

        assert [view(o) for o in check_ok()] == want

        # partition hostB <-> svc: degrade fast (the idle timeout, not
        # the request ceiling), cooldown armed, then heal and re-promote
        plane.partition_pairs({frozenset(("hostB", "svc"))})
        t0 = time.monotonic()
        assert client.check(packs) is None
        assert time.monotonic() - t0 < 30.0, "degradation took too long"
        assert client.broken
        plane.heal_partition()
        assert [view(o) for o in check_ok()] == want
        assert not client.broken

        # latency + jitter and slow-close: slow but correct
        plane.set_latency(30, 10)
        plane.set_slow_close(0.2)
        assert [view(o) for o in check_ok()] == want
        plane.heal()

        # fully lossy link: degrade; clear: recover
        plane.set_drop_prob(1.0)
        assert client.check(packs) is None
        plane.clear_drop_prob()
        assert [view(o) for o in check_ok()] == want
    finally:
        telemetry.set_current(prev if prev is not telemetry.NULL
                              else None)
        if client is not None:
            client.close()
        plane.close()
        svc.close()
        svc_mod.reset_clients()
    # the client reconnected (counted) rather than latching broken
    cctr = tel.summary().get("counters") or {}
    assert cctr.get("service.reconnects", 0) >= 1, cctr
    # every successful check's packs attributed to hostB's ledger row
    sctr = svc.stats().get("counters") or {}
    assert sctr.get("service.host_submitted.hostB") \
        == sctr.get("service.submitted"), sctr
