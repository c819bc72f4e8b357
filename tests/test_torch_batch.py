"""The port's keyed register check against the JAX reference: the lane
geometry, the wave kernel's batched launch split over 1, 2, 3 and 8
lanes (the counterpart of the reference's ``_call_batch_sharded``,
which runs here in interpret mode over the 8-device CPU mesh), the
batched ladder for leftover keys (``check_packed_batch``), and
``Independent`` over ``TPULinearizableChecker`` alone or composed, on
the shapes of ``tests/test_batch.py``.

Off the TPU the reference's checker skips its Pallas kernel
(``_run_fused`` returns None), so the dict-for-dict tests patch
``_run_fused`` to call through (a patch, not an edit of the reference):
its batch then takes the sharded interpret-mode kernel, as the port
takes its kernel's plain version. Unpatched, the reference runs every
key on its ladder, and the verdicts must still agree."""

import random

import jax
import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.checkers import Stats as RefStats
from jepsen_etcd_tpu.checkers import compose as ref_compose
from jepsen_etcd_tpu.checkers.independent import Independent as RefIndependent
from jepsen_etcd_tpu.checkers.session import \
    SessionGuarantees as RefSessionGuarantees
from jepsen_etcd_tpu.checkers.tpu_linearizable import \
    TPULinearizableChecker as RefChecker
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.history import columns_of as ref_columns_of
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.ops import wgl_mxu as ref_mxu
from jepsen_etcd_tpu_torch.checkers import (Independent, SessionGuarantees,
                                            Stats, TPULinearizableChecker,
                                            compose, independent_checker)
from jepsen_etcd_tpu_torch.core.history import History, columns_of
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu

from test_batch import keyed, multi_key_history
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_wgl import _concurrent_writes_history, gen_history

LANE_COUNTS = [1, 2, 3, 8]


def port_history(h) -> History:
    return History.from_jsonl(h.to_jsonl())


def port_pack(p) -> wgl.Packed:
    return wgl.Packed.from_numpy(vars(p))


@pytest.fixture
def fused_reference(monkeypatch):
    """The reference's checker with its Pallas kernel on (interpret
    mode off the TPU)."""
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())


def cpu_lanes(monkeypatch, n: int):
    """Make the port's batched launch split keys over n CPU lanes."""
    monkeypatch.setattr(wgl_mxu, "batch_lanes",
                        lambda device=None: [torch.device("cpu")] * n)


def strip_resume(outs):
    return [{k: v for k, v in o.items() if k != "_resume"} for o in outs]


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_batch_geometry_equals_the_references(monkeypatch, n):
    devices = jax.devices()
    assert len(devices) >= n
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: devices[:n])
    for K in range(1, 70):
        assert wgl_mxu._batch_geometry(K, n) == ref_mxu._batch_geometry(K)


def _supported_packs(seed, n, **kw):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        h = gen_history(rng, n_procs=3, n_ops=rng.choice([12, 30]),
                        corrupt=len(out) % 4 == 1, **kw)
        p = ref_wgl.pack_register_history(h)
        if p.ok and ref_mxu.supported(p):
            out.append(p)
    return out


@pytest.fixture(scope="module")
def reference_sharded_launch():
    """19 keys over two R buckets, launched by the reference over its
    8-device mesh in interpret mode (``_call_batch_sharded``)."""
    packs = _supported_packs(7, 19)
    assert len({max(ref_wgl.bucket(p.R), ref_mxu.TSUB) for p in packs}) > 1
    launched = ref_mxu.launch_packed_batch_mxu(packs)
    assert max(len(dev.sharding.device_set) for _, dev, _ in launched) == 8
    outs = [None] * len(packs)
    ref_mxu.collect_packed_batch_mxu(launched, outs)
    return packs, outs


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_sharded_launch_equals_the_references(monkeypatch, n,
                                              reference_sharded_launch):
    packs, ref_outs = reference_sharded_launch
    cpu_lanes(monkeypatch, n)
    ports = [port_pack(p) for p in packs]
    launched = wgl_mxu.launch_packed_batch_mxu(ports)
    # one search per lane used, per (r_pad, wk) chunk
    assert all(len(outs) == min(n, len(chunk))
               for chunk, outs, _ in launched)
    outs = [None] * len(ports)
    wgl_mxu.collect_packed_batch_mxu(launched, outs)
    assert outs == ref_outs
    assert wgl_mxu.check_packed_batch_mxu(ports) == ref_outs


def test_check_packed_batch_leftover_ladder_equals_the_references():
    """Info-op keys (the wave kernel cannot take them): groups of
    several keys run the batched rung (``batched: True``), lone keys
    climb the ladder, and a group whose keys overflow the rung at 128
    climbs per key from F_MAX; every dict equals the reference's."""
    rng = random.Random(5)
    packs = []
    for _ in range(14):
        p = ref_wgl.pack_register_history(gen_history(
            rng, n_procs=3, n_ops=18, info_rate=0.2))
        if p.ok and p.I:
            packs.append(p)
    packs += [ref_wgl.pack_register_history(_concurrent_writes_history(
        12, read_val=v)) for v in (9, 1)]
    ports = [port_pack(p) for p in packs]
    assert [wgl.group_key(p) for p in ports] == \
        [ref_wgl.group_key(p) for p in packs]
    ref = strip_resume(ref_wgl.check_packed_batch(packs, try_fused=False))
    got = strip_resume(wgl.check_packed_batch(ports, device="cpu"))
    assert got == ref
    assert sum(bool(o.get("batched")) for o in got) >= 2
    assert any(o.get("engine") == "jnp-ladder" for o in got)
    assert got[-2].get("rungs", 0) >= 2 and got[-1]["valid?"] is True


def uneven_history(history_cls, op_cls):
    rng = random.Random(13)
    ops = []
    ops.extend(keyed(gen_history(rng, n_procs=2, n_ops=6), "small", 0))
    ops.extend(keyed(gen_history(rng, n_procs=4, n_ops=40), "big", 100))
    # R = 0 key: a single info op, no required ops
    ops.append(op_cls(type="invoke", process=500, f="write",
                      value=("empty", [None, 3])))
    ops.append(op_cls(type="info", process=500, f="write",
                      value=("empty", [None, 3]), error="timeout"))
    return history_cls(ops)


#: test_batch.py's shapes: (name, history factory)
SHAPES = {
    "16 keys": lambda: multi_key_history(16, random.Random(41)),
    "corrupted keys": lambda: multi_key_history(6, random.Random(77),
                                                corrupt_keys=(2, 4)),
    "info ops": lambda: multi_key_history(8, random.Random(5),
                                          info_rate=0.2),
    "uneven R, all-info key": lambda: uneven_history(RefHistory, RefOp),
}


def _checkers(kind: str):
    """(reference checker, port checker) of one kind."""
    if kind == "linear":
        return (RefIndependent(RefChecker(cpu_cutoff=None)),
                Independent(TPULinearizableChecker(cpu_cutoff=None,
                                                   device="cpu")))
    if kind == "default routing":
        return (RefIndependent(RefChecker()),
                Independent(TPULinearizableChecker(device="cpu")))
    return (RefIndependent(ref_compose({
                "linear": RefChecker(cpu_cutoff=None),
                "stats": RefStats()})),
            independent_checker(compose({
                "linear": TPULinearizableChecker(cpu_cutoff=None,
                                                 device="cpu"),
                "stats": Stats()})))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["linear", "linear+stats",
                                  "default routing"])
def test_independent_equals_the_reference_dict_for_dict(
        monkeypatch, fused_reference, shape, kind):
    h = SHAPES[shape]()
    ref_checker, port_checker = _checkers(kind)
    ref = ref_checker.check({}, h)
    if kind == "linear+stats":
        cpu_lanes(monkeypatch, 3)
    got = port_checker.check({}, port_history(h))
    assert got == ref
    assert got["key-count"] == len(got["results"])
    if kind == "linear":
        engines = {r.get("engine") for r in got["results"].values()}
        if shape == "16 keys":
            assert engines == {"mxu-wave"}
        if shape == "info ops":
            assert any(r.get("batched") for r in got["results"].values())


@pytest.mark.parametrize("shape", list(SHAPES))
def test_independent_verdicts_equal_the_unpatched_reference(shape):
    h = SHAPES[shape]()
    ref_checker, port_checker = _checkers("linear")
    ref = ref_checker.check({}, h)
    got = port_checker.check({}, port_history(h))
    assert got["valid?"] == ref["valid?"]
    assert {k: r["valid?"] for k, r in got["results"].items()} == \
        {k: r["valid?"] for k, r in ref["results"].items()}


def test_register_workload_checker_equals_the_reference(fused_reference):
    """The register workload's checker, Independent(Compose({linear,
    session})), on a column-backed keyed history with corrupted and
    faulted keys."""
    rng = random.Random(23)
    ops = []
    for k in range(10):
        ops += keyed(gen_history(rng, n_procs=4, n_ops=40,
                                 corrupt=k in (1, 6),
                                 info_rate=0.1 if k in (2, 5, 8) else 0.0),
                     k, 10 * k)
    ref_h = RefHistory([op.evolve(time=t) for t, op in enumerate(ops)])
    ref_h = RefHistory(ref_h.ops, columns=ref_columns_of(ref_h.ops))
    port_h = port_history(ref_h)
    port_h = History(port_h.ops, columns=columns_of(port_h.ops))
    ref = RefIndependent(ref_compose({
        "linear": RefChecker(), "session": RefSessionGuarantees()})) \
        .check({}, ref_h)
    got = independent_checker(compose({
        "linear": TPULinearizableChecker(device="cpu"),
        "session": SessionGuarantees()})).check({}, port_h)
    assert got == ref
    assert got["valid?"] is False


def test_prepare_bucket_group_equals_the_references():
    """A ladder group's tables, padded to the group's (r_pad, info)
    shapes and stacked: the reference's rows for the group's real keys
    (it also pads the key axis, which the port's per-key rung never
    reads)."""
    rng = random.Random(9)
    packs = []
    while len(packs) < 3:
        p = ref_wgl.pack_register_history(gen_history(
            rng, n_procs=3, n_ops=18, info_rate=0.2))
        if p.ok and p.I and (not packs or ref_wgl.group_key(p) ==
                             ref_wgl.group_key(packs[0])):
            packs.append(p)
    ports = [port_pack(p) for p in packs]
    r_pad, info, _ = ref_wgl.group_key(packs[0])
    idxs = [2, 0, 1]
    ref = ref_wgl.prepare_bucket_group(packs, idxs, r_pad, info).stacked
    got = wgl.prepare_bucket_group(ports, idxs, r_pad, info)
    assert set(got) == set(ref)
    for name, arr in got.items():
        assert arr.dtype == ref[name].dtype
        assert np.array_equal(arr, ref[name][:len(idxs)]), name
