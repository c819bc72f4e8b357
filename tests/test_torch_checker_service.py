"""The port's checker service (``runner/checker_service.py``) and its
``Packed`` wire format against the JAX reference, on the CPU.

``serialize_packed`` must give the reference's bytes for the same
history, and each package must read the other's. Shipping a pack over
the socket must change nothing about its verdict: the service runs the
port's ``check_packed_batch``, whose dicts equal in-process checking and
the reference's ``check_packed_batch``. The service cases of
``tests/test_checker_service.py`` follow (coalescing, ``_resume`` never
on the wire, fallback, backoff and re-promotion, TCP auth, admission,
reconnect, wire-version mismatch, leaked threads, a failing tick), and
the repair of ``check_packed_batch``: on the card it runs the wave
kernel first, as the reference's does on its TPU; on the CPU (gate
closed) it stays on the ladder, as the reference's does there. The
lanes are ``wgl_mxu.batch_lanes``, substituted with CPU lanes."""

import dataclasses
import json
import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import checker_service as ref_svc
from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
    TPULinearizableChecker
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.runner import checker_service as svc_mod
from jepsen_etcd_tpu_torch.runner import telemetry, transport
from jepsen_etcd_tpu_torch.runner.telemetry import Telemetry

from test_torch_checker_service_lanes import sock_path, strip, use_lanes
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_wgl import (_concurrent_writes_history, gen_history,
                      gen_mutex_history)


def port_history(h) -> History:
    return History.from_jsonl(h.to_jsonl())


def pack_pairs(seed: int, n: int, info_rate: float = 0.1,
               corrupt: bool = False) -> list:
    """n (reference pack, port pack) pairs of one history each, both
    packers' own work."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        h = RefHistory(gen_history(rng, n_procs=rng.randint(2, 4),
                                   n_ops=rng.randint(8, 40),
                                   info_rate=info_rate, corrupt=corrupt))
        ref = ref_wgl.pack_register_history(h)
        if ref.ok and ref.R > 0:
            out.append((ref, wgl.pack_register_history(port_history(h))))
    return out


def port_packs(seed: int, n: int, **kw) -> list:
    return [p for _, p in pack_pairs(seed, n, **kw)]


def fuzz_pairs() -> list:
    return (pack_pairs(11, 6, info_rate=0.15)
            + pack_pairs(12, 4, corrupt=True)
            + pack_pairs(13, 2, info_rate=0.5))


#: what a verdict must keep whichever rung gave it; "rungs", "engine"
#: and "batched" follow the group a pack rode in (a pack alone climbs
#: the ladder; grouped, the batched rung), as in the reference's tests
PROJECTION = ("valid?", "waves", "peak-frontier", "ops", "info-ops",
              "op", "error", "stuck-at-depth")


def view(out: dict) -> dict:
    return {k: out.get(k) for k in PROJECTION}


def assert_fields_equal(a, b) -> None:
    for fld in dataclasses.fields(type(a)):
        x, y = getattr(a, fld.name), getattr(b, fld.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), fld.name
        else:
            assert x == y, (fld.name, x, y)


@pytest.fixture
def service(monkeypatch, tmp_path):
    use_lanes(monkeypatch, [torch.device("cpu")])
    svc = svc_mod.CheckerService(path=sock_path(tmp_path),
                                 tick_s=0.01).start()
    yield svc
    svc.close()
    svc_mod.reset_clients()
    assert svc.shutdown_leaked_threads == 0


# -- wire format -------------------------------------------------------------

def _mutex_pairs():
    rng = random.Random(5)
    out = []
    for trial in range(6):
        h = gen_mutex_history(rng, n_procs=3, n_ops=18,
                              corrupt=trial % 2 == 1)
        out.append((ref_wgl.pack_mutex_history(h),
                    wgl.pack_mutex_history(port_history(h))))
    return out


def _unpackable_pairs():
    bad = RefHistory([
        {"type": "invoke", "process": 0, "f": "write", "value": [None, 1]},
        {"type": "ok", "process": 0, "f": "write", "value": ["x", 1]}])
    empty = RefHistory([
        {"type": "invoke", "process": 0, "f": "write", "value": [None, 1]},
        {"type": "ok", "process": 0, "f": "write", "value": [None, 1]}])
    return [(ref_wgl.pack_register_history(h),
             wgl.pack_register_history(port_history(h)))
            for h in (bad, empty)]


PAIRS = {
    "fuzz": lambda: pack_pairs(3, 12, info_rate=0.0)
    + pack_pairs(4, 4, corrupt=True),
    "info-ops": lambda: pack_pairs(6, 8, info_rate=0.4),
    "mutex": _mutex_pairs,
    "unpackable": _unpackable_pairs,
}


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_serialize_packed_bytes_equal_the_references(kind):
    pairs = PAIRS[kind]()
    if kind == "unpackable":
        assert not pairs[0][1].ok
    for ref, port in pairs:
        want = ref_wgl.serialize_packed(ref)
        assert wgl.serialize_packed(port) == want
        # the frame tables never travel: materializing them first
        # changes nothing on the wire
        wgl.ensure_frames(port)
        assert wgl.serialize_packed(port) == want


def test_each_package_reads_the_others_bytes():
    for ref, port in fuzz_pairs() + _mutex_pairs():
        from_ref = wgl.deserialize_packed(ref_wgl.serialize_packed(ref))
        from_port = ref_wgl.deserialize_packed(wgl.serialize_packed(port))
        assert isinstance(from_ref, wgl.Packed)
        for got, want in ((from_ref, port), (from_port, ref)):
            wgl.ensure_frames(got) if isinstance(got, wgl.Packed) \
                else ref_wgl.ensure_frames(got)
            wgl.ensure_frames(want) if isinstance(want, wgl.Packed) \
                else ref_wgl.ensure_frames(want)
            assert_fields_equal(got, want)


def _mutate(buf: bytes, how: str) -> bytes:
    head, _, blobs = buf.partition(b"\n")
    h = json.loads(head)
    if how == "version":
        h["v"] = 99
    elif how == "unknown-array":
        h["arrays"][0][0] = "__class__"
    elif how == "frame-field":
        h["arrays"][0][0] = "pred_frame"
    elif how == "unknown-scalar":
        h["scalars"]["__dict__"] = 1
    elif how == "negative-shape":
        h["arrays"][0][2] = [-1]
    elif how == "float-shape":
        h["arrays"][0][2] = [1.5]
    elif how == "short-payload":
        blobs = blobs[:-1]
    elif how == "long-payload":
        blobs = blobs + b"\0"
    elif how == "malformed":
        h["scalars"] = []
    return json.dumps(h).encode() + b"\n" + blobs


@pytest.mark.parametrize("how", [
    "version", "unknown-array", "frame-field", "unknown-scalar",
    "negative-shape", "float-shape", "short-payload", "long-payload",
    "malformed"])
def test_deserialize_rejects_unknown_versions_and_hostile_headers(how):
    """Rejected before any array is built, as the reference rejects
    the same bytes."""
    (ref, port), = pack_pairs(4, 1)
    bad = _mutate(wgl.serialize_packed(port), how)
    with pytest.raises(ValueError):
        wgl.deserialize_packed(bad)
    with pytest.raises(ValueError):
        ref_wgl.deserialize_packed(bad)


# -- verdicts ----------------------------------------------------------------

def test_service_verdicts_equal_in_process_and_the_references(service):
    """Valid, corrupt and info-heavy packs through the socket, as one
    request and as singletons: every dict equals the port's in-process
    ``check_packed_batch`` and the reference's (both on the ladder on
    the CPU)."""
    pairs = fuzz_pairs()
    refs = [r for r, _ in pairs]
    packs = [p for _, p in pairs]
    local = strip(wgl.check_packed_batch(packs, device="cpu"))
    assert local == strip(ref_wgl.check_packed_batch(refs))
    assert any(o["valid?"] is False for o in local)
    client = svc_mod.CheckerClient(service.path)
    assert client.check(packs) == local
    for ref, p in pairs[:3]:
        assert client.check([p]) == \
            strip(ref_wgl.check_packed_batch([ref]))
    client.close()


def test_a_lone_pack_split_over_lanes_keeps_its_verdict(monkeypatch,
                                                       tmp_path):
    """Over two lanes a lone pack is a one-group tick split over both:
    the batched rung, where in-process it climbs the ladder. The
    verdict projection is the same (the reference's promise)."""
    use_lanes(monkeypatch, [torch.device("cpu")] * 2)
    svc = svc_mod.CheckerService(path=sock_path(tmp_path),
                                 tick_s=0.01).start()
    try:
        client = svc_mod.CheckerClient(svc.path)
        for ref, p in fuzz_pairs()[:4]:
            got, = client.check([p])
            assert got["batched"] is True
            assert view(got) == view(ref_wgl.check_packed_batch([ref])[0])
        client.close()
        ctr = svc.stats()["counters"]
    finally:
        svc.close()
        svc_mod.reset_clients()
    assert ctr["service.sharded_ticks"] == 4


def test_reference_client_talks_to_the_port_service(service):
    """The reference's client serializes with the reference's packer
    and framing; the port's service reads it and answers the same
    verdicts."""
    pairs = fuzz_pairs()[:5]
    client = ref_svc.CheckerClient(service.path)
    try:
        got = client.check([r for r, _ in pairs])
    finally:
        client.close()
    assert got == strip(wgl.check_packed_batch([p for _, p in pairs],
                                               device="cpu"))


def test_service_coalesces_concurrent_clients(service):
    """Requests from concurrent clients land in shared ticks: every
    pack is accounted for, and the ledger shows fewer group dispatches
    than packs."""
    packs = port_packs(21, 8)
    local = strip(wgl.check_packed_batch(packs, device="cpu"))
    results = [None] * 4
    warm = svc_mod.CheckerClient(service.path)
    assert warm.check(packs[:1]) is not None
    warm.close()
    go = threading.Barrier(4)

    def run(i):
        c = svc_mod.CheckerClient(service.path)
        go.wait(timeout=30)
        results[i] = c.check(packs[2 * i: 2 * i + 2])
        c.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i in range(4):
        assert results[i] is not None
        assert [view(o) for o in results[i]] == \
            [view(o) for o in local[2 * i: 2 * i + 2]]
    ctr = service.stats()["counters"]
    assert ctr["service.requests"] == 5
    assert ctr["service.submitted"] == 9
    assert ctr["service.ticks"] >= 1
    disp = sum(v for k, v in ctr.items()
               if k.startswith("service.device_dispatches."))
    assert disp == ctr["service.group_ticks"] + \
        ctr.get("service.shard_fanout", 0)
    assert ctr["service.coalesced"] == 9 - ctr["service.group_ticks"]


def test_resume_state_never_crosses_the_wire(service, monkeypatch):
    """Device-tensor resume state must be stripped before the verdict
    is serialized: the client gets clean JSON."""
    pack = port_packs(31, 1)[0]
    real = wgl.check_packed_batch

    def overflowing(packs, **kw):
        outs = real(packs, **kw)
        for o in outs:
            o["_resume"] = (torch.zeros(3), object(), 3)
        return outs

    monkeypatch.setattr(wgl, "check_packed_batch", overflowing)
    client = svc_mod.CheckerClient(service.path)
    outs = client.check([pack])
    client.close()
    assert outs is not None and "_resume" not in outs[0]
    assert outs == strip(real([pack], device="cpu"))


def test_plain_turns_tensors_and_numpy_scalars_into_json():
    got = svc_mod._plain({"a": np.int64(3), "b": torch.tensor(2.5),
                          "c": (np.bool_(True), None), "d": "x"})
    assert got == {"a": 3, "b": 2.5, "c": [True, None], "d": "x"}
    json.dumps(got)


# -- degradation -------------------------------------------------------------

def test_checker_falls_back_when_service_down(tmp_path):
    """A configured but dead endpoint degrades to in-process checking:
    the same dict, one service.fallback, no error."""
    rng = random.Random(41)
    h = port_history(RefHistory(gen_history(rng, n_procs=3, n_ops=24,
                                            info_rate=0.1)))
    checker = TPULinearizableChecker(cpu_cutoff=None, device="cpu")
    want = checker.check({}, h)
    svc_mod.reset_clients()
    tel = Telemetry()
    prev = telemetry.current()
    telemetry.set_current(tel)
    try:
        got = checker.check({"checker_service": sock_path(tmp_path)}, h)
    finally:
        telemetry.set_current(prev if prev is not telemetry.NULL
                              else None)
        svc_mod.reset_clients()
    assert got == want
    ctr = tel.summary()["counters"]
    assert ctr["service.fallback"] == 1
    assert ctr[f"engine.{want['engine']}"] == 1


def test_client_for_negative_cache_expires_and_repromotes(tmp_path,
                                                          monkeypatch):
    """A dead endpoint is a cooldown entry (no connect storm while it
    lasts); once it expires the endpoint is re-probed, and a service
    that came up late is adopted."""
    use_lanes(monkeypatch, [torch.device("cpu")])
    monkeypatch.setattr(svc_mod, "RETRY_BASE_S", 0.05)
    monkeypatch.setattr(svc_mod, "RETRY_CAP_S", 0.1)
    svc_mod.reset_clients()
    path = sock_path(tmp_path)
    test = {"checker_service": path}
    try:
        assert svc_mod.client_for(test) is None
        cached = svc_mod._clients[path]
        assert cached.fails == 1 and cached.broken
        assert svc_mod.client_for(test) is None
        assert cached.fails == 1
        svc = svc_mod.CheckerService(path=path, tick_s=0.01).start()
        try:
            deadline = time.monotonic() + 5.0
            client = None
            while client is None and time.monotonic() < deadline:
                time.sleep(0.02)
                client = svc_mod.client_for(test)
            assert client is cached, "healed endpoint not re-promoted"
            assert not client.broken and client.fails == 0
            pack = port_packs(61, 1)[0]
            assert client.check([pack]) == strip(
                wgl.check_packed_batch([pack], device="cpu"))
        finally:
            svc.close()
    finally:
        svc_mod.reset_clients()


def test_tcp_transport_auth_and_host_attribution(monkeypatch, tmp_path):
    """The TCP listener speaks the unix socket's protocol, rejects a
    wrong secret at hello, and attributes packs to the host."""
    use_lanes(monkeypatch, [torch.device("cpu")])
    svc = svc_mod.CheckerService(path=sock_path(tmp_path), tick_s=0.01,
                                 tcp=True, auth_token="sekrit").start()
    try:
        assert svc.tcp_endpoint.startswith("tcp://127.0.0.1:")
        bad = svc_mod.CheckerClient(svc.tcp_endpoint, token="wrong",
                                    connect_timeout=2.0)
        assert bad.ping() is False
        bad.close()
        good = svc_mod.CheckerClient(svc.tcp_endpoint, token="sekrit",
                                     host="hostB")
        packs = port_packs(91, 3)
        assert good.check(packs) == strip(
            wgl.check_packed_batch(packs, device="cpu"))
        good.close()
        ctr = svc.stats()["counters"]
        assert ctr["service.auth_rejects"] >= 1
        assert ctr["service.host_submitted.hostB"] == 3
    finally:
        svc.close()
        svc_mod.reset_clients()


def test_admission_control_busy_is_bounded(monkeypatch, tmp_path):
    """A saturated service answers BUSY at once, the client's retries
    are bounded, and BUSY arms no reconnect cooldown."""
    use_lanes(monkeypatch, [torch.device("cpu")])
    svc = svc_mod.CheckerService(path=sock_path(tmp_path), tick_s=0.01,
                                 max_pending_packs=2).start()
    release = threading.Event()
    real = wgl.check_packed_batch

    def stalled(packs, **kw):
        assert release.wait(timeout=30.0), "test deadlocked"
        return real(packs, **kw)

    monkeypatch.setattr(wgl, "check_packed_batch", stalled)
    hold_result = [None]

    def hold():
        c = svc_mod.CheckerClient(svc.path)
        hold_result[0] = c.check(port_packs(81, 2))
        c.close()

    t = threading.Thread(target=hold)
    try:
        t.start()
        deadline = time.monotonic() + 10.0
        while svc._pending_packs < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc._pending_packs == 2
        probe = svc_mod.CheckerClient(svc.path, max_busy_retries=1)
        assert probe.check(port_packs(82, 1)) is None  # saturated
        assert probe.available() and probe.fails == 0
        ctr = svc.stats()["counters"]
        assert ctr["service.admission_rejects"] >= 2
        release.set()
        t.join(timeout=30.0)
        assert not t.is_alive() and hold_result[0] is not None
        assert probe.check(port_packs(83, 1)) is not None  # drained
        probe.close()
    finally:
        release.set()
        svc.close()
        svc_mod.reset_clients()


def test_reconnect_after_service_restart(monkeypatch, tmp_path):
    """A client that watched its service die degrades (None), arms a
    capped-backoff cooldown, and re-promotes once the service is back,
    counting service.reconnects."""
    use_lanes(monkeypatch, [torch.device("cpu")])
    monkeypatch.setattr(svc_mod, "RETRY_BASE_S", 0.05)
    monkeypatch.setattr(svc_mod, "RETRY_CAP_S", 0.1)
    path = sock_path(tmp_path)
    pack = port_packs(101, 1)[0]
    want = strip(wgl.check_packed_batch([pack], device="cpu"))
    svc = svc_mod.CheckerService(path=path, tick_s=0.01).start()
    client = svc_mod.CheckerClient(path)
    tel = Telemetry()
    prev = telemetry.current()
    telemetry.set_current(tel)
    try:
        assert client.check([pack]) == want
        svc.close()
        assert client.check([pack]) is None
        assert client.broken and client.fails >= 1
        svc2 = svc_mod.CheckerService(path=path, tick_s=0.01).start()
        try:
            deadline = time.monotonic() + 5.0
            outs = None
            while outs is None and time.monotonic() < deadline:
                time.sleep(0.02)
                outs = client.check([pack])
            assert outs == want
            assert client.fails == 0 and not client.broken
        finally:
            svc2.close()
    finally:
        telemetry.set_current(prev if prev is not telemetry.NULL
                              else None)
        client.close()
        svc_mod.reset_clients()
    assert tel.summary()["counters"]["service.reconnects"] >= 1


def test_version_mismatch_mid_stream_keeps_connection(service):
    """A pack claiming an unknown wire version gets an error reply, and
    the same connection then serves a good check."""
    pack = port_packs(111, 1)[0]
    good = wgl.serialize_packed(pack)
    bad = _mutate(good, "version")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(service.path)
    s.settimeout(10.0)
    r = transport.FrameReader(s)

    def rpc(head_obj, body=b""):
        transport.send_frame(
            s, json.dumps(head_obj).encode() + b"\n" + body)
        while True:
            fr = r.recv_frame()
            assert fr is not None, "service closed the connection"
            resp = json.loads(fr.decode())
            if "heartbeat" not in resp:
                return resp

    try:
        resp = rpc({"op": "check", "sizes": [len(bad)], "id": 1}, bad)
        assert resp["id"] == 1 and resp.get("error"), resp
        resp = rpc({"op": "check", "sizes": [len(good)], "id": 2}, good)
        assert resp["id"] == 2
        assert resp["results"] == strip(
            wgl.check_packed_batch([pack], device="cpu"))
    finally:
        s.close()
    assert service.stats()["counters"]["service.bad_requests"] == 1


def test_shutdown_counts_leaked_threads(monkeypatch, tmp_path):
    """A thread that outlives the join grace is a ledger entry, not a
    silently discarded join result."""
    use_lanes(monkeypatch, [torch.device("cpu")])
    svc = svc_mod.CheckerService(path=sock_path(tmp_path), tick_s=0.01,
                                 shutdown_join_s=0.1).start()
    release = threading.Event()
    hung = threading.Thread(target=release.wait, name="wedged-worker",
                            daemon=True)
    hung.start()
    with svc._cv:
        svc._threads.append(hung)
    try:
        svc.close()
        assert svc.shutdown_leaked_threads >= 1
        st = svc.stats()
        assert st["shutdown_leaked_threads"] >= 1
        assert st["counters"]["service.shutdown_leaked_threads"] >= 1
    finally:
        release.set()
        hung.join(timeout=5.0)
        svc_mod.reset_clients()
    assert not hung.is_alive()


def test_service_survives_checker_exception(service, monkeypatch):
    """A tick that raises is answered with an error (the client returns
    None, so the caller checks in-process), and the next request
    succeeds: the service never wedges."""
    pack = port_packs(51, 1)[0]
    real = wgl.check_packed_batch

    def boom(packs, **kw):
        raise RuntimeError("injected tick failure")

    monkeypatch.setattr(wgl, "check_packed_batch", boom)
    client = svc_mod.CheckerClient(service.path)
    assert client.check([pack]) is None
    assert client.fails == 0  # an error reply is not a dead transport
    monkeypatch.setattr(wgl, "check_packed_batch", real)
    assert client.check([pack]) == strip(real([pack], device="cpu"))
    client.close()


# -- the repair: the wave kernel first ---------------------------------------

def test_wave_kernel_first_equals_the_references_fused_path(monkeypatch):
    """With the gate open (on the card; patched open here, so the
    kernel's plain version runs), ``check_packed_batch`` gives, key for
    key, the reference's fused path: its Pallas batch in interpret mode
    (``_run_fused`` patched to call through), merged with its ladder
    for the keys the kernel cannot take (info ops) or that overflow.
    Gate closed, both stay on the ladder."""
    pairs = (pack_pairs(7, 6, info_rate=0.0)
             + pack_pairs(8, 2, info_rate=0.0, corrupt=True)
             + pack_pairs(9, 3, info_rate=0.3))
    for v in (9, 1):
        h = _concurrent_writes_history(12, read_val=v)
        pairs.append((ref_wgl.pack_register_history(h),
                      wgl.pack_register_history(port_history(h))))
    refs = [r for r, _ in pairs]
    ports = [p for _, p in pairs]
    closed = strip(wgl.check_packed_batch(ports, device="cpu"))
    assert closed == strip(ref_wgl.check_packed_batch(refs))
    assert all(o.get("engine") != "mxu-wave" for o in closed)
    monkeypatch.setattr(wgl, "_b1_first", lambda device: True)
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    got = strip(wgl.check_packed_batch(ports, device="cpu"))
    assert got == strip(ref_wgl.check_packed_batch(refs))
    engines = [o.get("engine") for o in got]
    assert engines.count("mxu-wave") >= 8
    assert any(o.get("batched") or o.get("rungs") for o in got)


def test_wave_kernel_failure_raises(monkeypatch):
    """No degrade-on-failure: a failing kernel raises out of
    ``check_packed_batch`` (and so out of a service tick as an error
    reply), where the reference would disable it and take the
    ladder."""
    ports = port_packs(7, 3, info_rate=0.0)
    monkeypatch.setattr(wgl, "_b1_first", lambda device: True)

    def broken(packs, device=None):
        raise RuntimeError("wgl_wave launch failed")

    monkeypatch.setattr(wgl_mxu, "check_packed_batch_mxu", broken)
    with pytest.raises(RuntimeError, match="wgl_wave launch failed"):
        wgl.check_packed_batch(ports, device="cpu")
    # the checker's leftovers never retry the kernel
    assert strip(wgl.check_packed_batch(ports, try_fused=False,
                                        device="cpu")) == \
        strip(ref_wgl.check_packed_batch(
            [ref for ref, _ in pack_pairs(7, 3, info_rate=0.0)]))
