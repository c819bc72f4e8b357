"""The port's checker service over several lanes, on the port alone (no
JAX here, so the ``cuda`` test also runs on a machine with a card and
no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_checker_service_lanes.py``).

The lanes are ``wgl_mxu.batch_lanes``, substituted here with n CPU
lanes (the reference's tests force an n-device CPU mesh): sticky
round-robin placement of group shapes over the lanes, the per-lane
dispatch ledger, one group alone in a tick split over every lane (the
sharded rung, the reference's ``_batched_kernel_sharded``), and dicts
that do not depend on the lane count."""

import os
import random
import tempfile

import pytest
import torch

from jepsen_etcd_tpu_torch.checkers import (SessionGuarantees,
                                            TPULinearizableChecker,
                                            compose, independent_checker)
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.runner import checker_service as svc_mod
from jepsen_etcd_tpu_torch.runner import telemetry
from jepsen_etcd_tpu_torch.runner.telemetry import Telemetry
from jepsen_etcd_tpu_torch.testing import (concurrent_writes_history,
                                           gen_history, keyed)

from test_torch_fixtures import one_torch_thread  # noqa: F401

LANE_COUNTS = [1, 2, 3, 8]


def use_lanes(monkeypatch, lanes: list) -> None:
    """Make ``batch_lanes`` answer ``lanes`` (one lane when a device is
    named, as it does)."""
    monkeypatch.setattr(
        wgl_mxu, "batch_lanes",
        lambda device=None: [torch.device(device)] if device is not None
        else list(lanes))


def sock_path(tmp_path) -> str:
    """A unix socket path short enough for the ~108-byte limit."""
    path = str(tmp_path / "s.sock")
    if len(path) < 100:
        return path
    return os.path.join(tempfile.mkdtemp(prefix="jet-"), "s.sock")


def make_packs(seed: int, n: int, info_rate: float = 0.1,
               corrupt: bool = False) -> list:
    rng = random.Random(seed)
    packs = []
    while len(packs) < n:
        p = wgl.pack_register_history(gen_history(
            rng, n_procs=rng.randint(2, 4), n_ops=rng.randint(8, 40),
            info_rate=info_rate, corrupt=corrupt))
        if p.ok and p.R > 0:
            packs.append(p)
    return packs


def one_shape_packs(seed: int, n: int) -> list:
    """n packs sharing one group key, so that a tick holding them sees
    one group: the sharded trigger."""
    rng = random.Random(seed)
    packs = []
    while len(packs) < n:
        p = wgl.pack_register_history(gen_history(rng, n_procs=3,
                                                  n_ops=12))
        if p.ok and p.R > 0 and (not packs or wgl.group_key(p) ==
                                 wgl.group_key(packs[0])):
            packs.append(p)
    return packs


def long_packs(n: int) -> list:
    """n packs of one group deep enough (R >= 300) that the ladder
    replays their waves from CUDA graphs on the card."""
    rng = random.Random(91)
    packs = []
    while len(packs) < n:
        p = wgl.pack_register_history(gen_history(rng, n_procs=4,
                                                  n_ops=400))
        if p.ok and p.R >= 300 and (not packs or wgl.group_key(p) ==
                                    wgl.group_key(packs[0])):
            packs.append(p)
    return packs


def fuzz_packs() -> list:
    """Valid, corrupt and info-op packs over several group shapes, and
    two whose frontiers overflow the batched rung (they climb on)."""
    return (make_packs(11, 6, info_rate=0.15)
            + make_packs(12, 4, corrupt=True)
            + make_packs(13, 2, info_rate=0.5)
            + [wgl.pack_register_history(concurrent_writes_history(
                12, read_val=v)) for v in (9, 1)])


def strip(outs: list) -> list:
    return [{k: v for k, v in o.items() if k != "_resume"} for o in outs]


def in_process(packs: list) -> list:
    return strip(wgl.check_packed_batch(list(packs), device="cpu"))


@pytest.fixture
def lanes8(monkeypatch):
    lanes = [torch.device("cpu")] * 8
    use_lanes(monkeypatch, lanes)
    return lanes


@pytest.fixture
def service(lanes8, tmp_path):
    svc = svc_mod.CheckerService(path=sock_path(tmp_path),
                                 tick_s=0.01).start()
    yield svc
    svc.close()
    svc_mod.reset_clients()
    assert svc.shutdown_leaked_threads == 0


def test_device_and_lane_names():
    assert svc_mod.device_name(torch.device("cpu")) == "cpu0"
    assert svc_mod.device_name(torch.device("cuda", 3)) == "cuda3"
    assert svc_mod.lane_names([torch.device("cuda", i)
                               for i in range(2)]) == ["cuda0", "cuda1"]
    assert svc_mod.lane_names([torch.device("cpu")] * 3) == \
        ["cpu0.0", "cpu0.1", "cpu0.2"]


def test_lanes_default_to_every_card_and_raise_without_one(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc_mod.DevicePlacement().devices()
    svc = svc_mod.CheckerService(path=sock_path(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.start()
    assert not os.path.exists(svc.path)


def test_placement_round_robin_and_sticky(lanes8):
    """Eight group shapes take the eight lanes; asking again for any
    shape returns its first lane."""
    pl = svc_mod.DevicePlacement()
    keys = [(16 * (1 << i), (0, 0, 0), 32) for i in range(8)]
    first = {k: pl.assign(k) for k in keys}
    assert {idx for idx, _ in first.values()} == set(range(8))
    for k in reversed(keys):
        assert pl.assign(k) == first[k]
    snap = pl.snapshot()
    assert set(snap.values()) == {f"cpu0.{i}" for i in range(8)}
    # a ninth shape wraps round to lane 0
    assert pl.assign((16 << 8, (0, 0, 0), 32))[0] == 0


def test_fallback_device_for_places_through_the_process_map(
        monkeypatch, lanes8):
    monkeypatch.setattr(svc_mod, "_process_placement", None)
    tel = Telemetry()
    dev_for = svc_mod.fallback_device_for(tel)
    assert dev_for((16, (0, 0, 0), 32)) == torch.device("cpu")
    assert dev_for((32, (0, 0, 0), 32)) == torch.device("cpu")
    assert svc_mod.process_placement().snapshot() == {
        repr((16, (0, 0, 0), 32)): "cpu0.0",
        repr((32, (0, 0, 0), 32)): "cpu0.1"}
    ctr = tel.summary()["counters"]
    assert ctr["service.fallback.cpu0.0"] == 1
    assert ctr["service.fallback.cpu0.1"] == 1
    use_lanes(monkeypatch, [torch.device("cpu")])
    monkeypatch.setattr(svc_mod, "_process_placement", None)
    assert svc_mod.fallback_device_for(tel) is None


def test_groups_spread_and_per_lane_ledger(service):
    """Mixed group shapes through a live service: distinct shapes on
    distinct lanes, and the per-lane dispatch counters sum exactly to
    the tick totals."""
    packs = fuzz_packs()
    client = svc_mod.CheckerClient(service.path)
    outs = client.check(packs)
    client.close()
    assert outs == in_process(packs)
    st = service.stats()
    assert st["devices"] == [f"cpu0.{i}" for i in range(8)]
    n_groups = len({wgl.group_key(p) for p in packs})
    assert n_groups > 1
    assert len(st["placement"]) == n_groups
    assert len(set(st["placement"].values())) == min(n_groups, 8)
    ctr = st["counters"]
    disp = {k: v for k, v in ctr.items()
            if k.startswith("service.device_dispatches.")}
    assert sum(disp.values()) == (ctr["service.group_ticks"]
                                  + ctr.get("service.shard_fanout", 0))
    assert ctr["service.device_occupancy"] == min(n_groups, 8)
    assert ctr["service.submitted"] == len(packs)
    assert ctr["service.wgl_wave_launches"] == 0  # the CPU: ladder only


def test_single_oversized_group_shards_across_all_lanes(service):
    """One group of 2 x 8 packs in a tick is split over every lane; the
    fan-out is ledgered per lane and the dicts equal in-process
    checking."""
    packs = one_shape_packs(31, 16)
    client = svc_mod.CheckerClient(service.path)
    outs = client.check(packs)
    client.close()
    assert outs == in_process(packs)
    assert all(o.get("batched") for o in outs)
    ctr = service.stats()["counters"]
    assert ctr["service.sharded_ticks"] >= 1
    disp = {k: v for k, v in ctr.items()
            if k.startswith("service.device_dispatches.")}
    assert set(disp) == {f"service.device_dispatches.cpu0.{i}"
                         for i in range(8)}
    assert sum(disp.values()) == (ctr["service.group_ticks"]
                                  + ctr["service.shard_fanout"])
    assert ctr["service.shard_fanout"] == 7 * ctr["service.sharded_ticks"]


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_service_dicts_identical_across_lane_counts(monkeypatch, tmp_path,
                                                    n):
    """The same fuzz, as one request and as a lone one-shape group,
    through a service over n lanes: every dict equals in-process
    checking."""
    use_lanes(monkeypatch, [torch.device("cpu")] * n)
    packs = fuzz_packs()
    lone = one_shape_packs(41, 3)
    svc = svc_mod.CheckerService(path=sock_path(tmp_path),
                                 tick_s=0.01).start()
    try:
        client = svc_mod.CheckerClient(svc.path)
        assert client.check(packs) == in_process(packs)
        assert client.check(lone) == in_process(lone)
        client.close()
        ctr = svc.stats()["counters"]
    finally:
        svc.close()
    assert svc.shutdown_leaked_threads == 0
    assert ctr.get("service.sharded_ticks", 0) == (n > 1)


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_sharded_rung_equals_unsharded(monkeypatch, n):
    """``check_packed_batch(shard=True)`` splits each group's keys over
    n lanes (padding keys never searched): every key of a group of
    several gets the unsharded rung's dict. A pack alone in its group
    takes the batched rung when sharded (as the reference's does),
    where unsharded it climbs the ladder: the same verdict and depth."""
    use_lanes(monkeypatch, [torch.device("cpu")] * n)
    packs = fuzz_packs() + one_shape_packs(51, 5)
    want = in_process(packs)
    got = strip(wgl.check_packed_batch(packs, shard=True))
    sizes = {}
    for p in packs:
        sizes[wgl.group_key(p)] = sizes.get(wgl.group_key(p), 0) + 1
    grouped = [i for i, p in enumerate(packs)
               if sizes[wgl.group_key(p)] > 1]
    lone = [i for i in range(len(packs)) if i not in grouped]
    assert len(grouped) >= 7 and lone
    assert [got[i] for i in grouped] == [want[i] for i in grouped]
    assert any(got[i].get("rungs", 0) >= 2 for i in grouped)
    shown = ("valid?", "waves", "ops", "info-ops")
    for i in lone:
        assert got[i]["batched"] is True
        assert {k: got[i][k] for k in shown} == \
            {k: want[i][k] for k in shown}


def test_prepared_groups_pad_per_lane_and_rebuild_on_a_mismatch(
        monkeypatch):
    packs = one_shape_packs(71, 5)
    key = wgl.group_key(packs[0])
    prep = wgl.prepare_bucket_group(packs, [0, 1, 2, 3, 4], key[0],
                                    key[1], lanes=3)
    assert (prep.n, prep.lanes, prep.k_pad) == (5, 3, 6)
    assert prep.Rs.tolist() == [p.R for p in packs] + [0]
    assert all(a.shape[0] == 6 for a in prep.stacked.values())
    assert all(a.shape[0] == 5 for a in prep.values())
    assert prep.fits(packs, [0, 1, 2, 3, 4], key, 3)
    assert not prep.fits(packs, [0, 1, 2, 3, 4], key, 1)
    assert not prep.fits(packs, [1, 0, 2, 3, 4], key, 3) or \
        packs[0].R == packs[1].R
    use_lanes(monkeypatch, [torch.device("cpu")] * 3)
    want = in_process(packs)
    calls = []
    real = wgl.prepare_bucket_group

    def counted(*a, **kw):
        calls.append(kw.get("lanes"))
        return real(*a, **kw)

    monkeypatch.setattr(wgl, "prepare_bucket_group", counted)
    # fits: used as given
    assert strip(wgl.check_packed_batch(packs, shard=True,
                                        prepared={key: prep})) == want
    assert calls == []
    # prepared for one lane, run over three: rebuilt
    one = real(packs, [0, 1, 2, 3, 4], key[0], key[1], lanes=1)
    assert strip(wgl.check_packed_batch(packs, shard=True,
                                        prepared={key: one})) == want
    assert calls == [3]


def test_checker_through_the_service_equals_in_process(monkeypatch,
                                                       tmp_path, lanes8):
    """``Independent(Compose({linear, session}))`` with the service
    configured: every key's dict equals the in-process check's (the
    wave kernel's gate patched open, so the service runs its plain
    version first as the checker does in-process), the runs' shipped
    packs equal the service's submitted, and nothing fell back."""
    monkeypatch.setattr(wgl, "_b1_first", lambda device: True)
    rng = random.Random(81)
    ops = []
    for k in range(5):
        h = gen_history(rng, n_procs=3, n_ops=40,
                        info_rate=0.1 if k == 2 else 0.0,
                        corrupt=k == 3)
        ops += keyed(h, k, 10 * k)
    history = History(ops)

    def checker():
        return independent_checker(compose({
            "linear": TPULinearizableChecker(device="cpu",
                                             cpu_cutoff=None),
            "session": SessionGuarantees()}))

    want = checker().check({}, history)
    svc = svc_mod.CheckerService(path=sock_path(tmp_path),
                                 tick_s=0.01).start()
    tel = Telemetry()
    prev = telemetry.current()
    telemetry.set_current(tel)
    try:
        got = checker().check({"checker_service": svc.path}, history)
        ctr_svc = svc.stats()["counters"]
    finally:
        telemetry.set_current(prev if prev is not telemetry.NULL
                              else None)
        svc.close()
        svc_mod.reset_clients()
    assert got == want
    assert got["valid?"] is False
    ctr = tel.summary()["counters"]
    assert "service.fallback" not in ctr
    assert ctr["service.shipped"] == ctr_svc["service.submitted"] == 5
    assert sum(v for k, v in ctr.items() if k.startswith("engine.")) == 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_lanes_of_the_card_equal_one(monkeypatch, tmp_path,
                                         cuda_device):
    """On the card the service runs the wave kernel first; over two
    lanes of it (groups placed, then one group split) every dict equals
    one lane's, and the sharded rung equals the unsharded one."""
    packs = fuzz_packs()
    lone = one_shape_packs(41, 6)
    got = {}
    for n in (1, 2):
        use_lanes(monkeypatch, [cuda_device] * n)
        svc = svc_mod.CheckerService(path=sock_path(tmp_path),
                                     tick_s=0.01).start()
        try:
            client = svc_mod.CheckerClient(svc.path)
            got[n] = (client.check(packs), client.check(lone))
            client.close()
            ctr = svc.stats()["counters"]
        finally:
            svc.close()
        assert ctr["service.wgl_wave_launches"] >= 1
        assert got[n][0] is not None and got[n][1] is not None
    assert got[2] == got[1]
    assert any(o.get("engine") == "mxu-wave" for o in got[1][0])
    # the sharded rung on two lanes of the card: long enough for each
    # lane to replay its waves from CUDA graphs it captures itself
    use_lanes(monkeypatch, [cuda_device] * 2)
    rung = long_packs(4) + lone
    want = strip(wgl.check_packed_batch(rung, try_fused=False,
                                        device=cuda_device))
    assert strip(wgl.check_packed_batch(rung, try_fused=False,
                                        shard=True)) == want
    assert all(o.get("batched") for o in want)
    assert max(o["waves"] for o in want) >= wgl.GRAPH_MIN_WAVES


@pytest.mark.cuda
def test_card_runs_the_wave_kernel_first(monkeypatch, cuda_device):
    """On the card ``check_packed_batch`` launches the wave kernel
    first (one launch per (R-bucket, width) group of the keys it takes)
    and its dicts equal the CPU's with the gate patched open (the plain
    version); a failing kernel raises."""
    packs = fuzz_packs()
    groups = {(max(wgl.bucket(p.R), wgl_mxu.TSUB), p.w) for p in packs
              if wgl_mxu.supported(p)}
    before = wgl_mxu.LAUNCHES
    got = strip(wgl.check_packed_batch(packs, device=cuda_device))
    assert wgl_mxu.LAUNCHES - before == len(groups)
    assert any(o.get("engine") == "mxu-wave" for o in got)
    monkeypatch.setattr(wgl, "_b1_first", lambda device: True)
    assert strip(wgl.check_packed_batch(packs, device="cpu")) == got
    from jepsen_etcd_tpu_torch.ops import _cuda

    def broken(*args, **kwargs):
        raise RuntimeError("wgl_wave launch failed")

    monkeypatch.setattr(_cuda, "wgl_wave", broken)
    with pytest.raises(RuntimeError, match="wgl_wave launch failed"):
        wgl.check_packed_batch(packs, device=cuda_device)
