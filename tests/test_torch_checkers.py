"""Twin of the reference's ``tests/test_checkers.py`` on the port: the
CPU linearizability oracle on known-good and known-bad histories, each
dict equal to the reference's. Also the checker API the port restored
(``LinearizableChecker``, ``linearizable``, ``tpu_linearizable``), each
against the reference's, and the reference's session write count, which
follows the history's representation, pinned on a fixed history for
both packages."""

import pytest

from jepsen_etcd_tpu.checkers import LinearizableChecker as \
    RefLinearizableChecker
from jepsen_etcd_tpu.checkers import check_history as ref_check_history
from jepsen_etcd_tpu.checkers import linearizable as ref_linearizable
from jepsen_etcd_tpu.checkers.tpu_linearizable import \
    tpu_linearizable as ref_tpu_linearizable
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.models import CASRegister as RefCASRegister
from jepsen_etcd_tpu.models import Mutex as RefMutex
from jepsen_etcd_tpu.models import VersionedRegister as RefVR
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu_torch.checkers import (LinearizableChecker,
                                            check_history, linearizable)
from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import (
    TPULinearizableChecker, tpu_linearizable)
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.models import VersionedRegister, CASRegister, \
    Mutex
from test_torch_fixtures import REF, PORT, as_json, mod
from test_torch_fixtures import one_torch_thread  # noqa: F401

REF_MODEL = {VersionedRegister: RefVR, CASRegister: RefCASRegister,
             Mutex: RefMutex}


def H(*ops):
    return History([Op(o) for o in ops])


def inv(p, f, v):
    return {"type": "invoke", "process": p, "f": f, "value": v}


def ok(p, f, v):
    return {"type": "ok", "process": p, "f": f, "value": v}


def info(p, f, v):
    return {"type": "info", "process": p, "f": f, "value": v}


def fail(p, f, v):
    return {"type": "fail", "process": p, "f": f, "value": v}


def checked(model, h) -> dict:
    """The port's ``check_history`` dict, held equal to the reference's
    on the same history."""
    got = check_history(model, h)
    want = ref_check_history(REF_MODEL[type(model)](),
                             RefHistory.from_jsonl(h.to_jsonl()))
    assert as_json(got) == as_json(want)
    return got


def test_trivial_valid():
    h = H(inv(0, "write", [None, 3]), ok(0, "write", [1, 3]),
          inv(0, "read", [None, None]), ok(0, "read", [1, 3]))
    assert checked(VersionedRegister(), h)["valid?"] is True


def test_stale_read_invalid():
    h = H(inv(0, "write", [None, 3]), ok(0, "write", [1, 3]),
          inv(0, "write", [None, 4]), ok(0, "write", [2, 4]),
          inv(0, "read", [None, None]), ok(0, "read", [1, 3]))
    r = checked(VersionedRegister(), h)
    assert r["valid?"] is False


def test_concurrent_reads_both_orders_valid():
    h = H(inv(0, "write", [None, 1]), inv(1, "write", [None, 2]),
          ok(1, "write", [None, 2]), ok(0, "write", [None, 1]),
          inv(2, "read", [None, None]), ok(2, "read", [2, 1]))
    assert checked(VersionedRegister(), h)["valid?"] is True


def test_info_op_may_or_may_not_happen():
    h = H(inv(0, "write", [None, 9]), info(0, "write", [None, 9]),
          inv(1, "read", [None, None]), ok(1, "read", [1, 9]))
    assert checked(VersionedRegister(), h)["valid?"] is True
    h2 = H(inv(0, "write", [None, 9]), info(0, "write", [None, 9]),
           inv(1, "read", [None, None]), ok(1, "read", [0, None]))
    assert checked(VersionedRegister(), h2)["valid?"] is True


def test_failed_op_must_not_happen():
    h = H(inv(0, "write", [None, 9]), fail(0, "write", [None, 9]),
          inv(1, "read", [None, None]), ok(1, "read", [1, 9]))
    assert checked(VersionedRegister(), h)["valid?"] is False


def test_cas_semantics():
    h = H(inv(0, "write", [None, 1]), ok(0, "write", [1, 1]),
          inv(0, "cas", [None, [1, 5]]), ok(0, "cas", [2, [1, 5]]),
          inv(0, "read", [None, None]), ok(0, "read", [2, 5]))
    assert checked(VersionedRegister(), h)["valid?"] is True
    h2 = H(inv(0, "write", [None, 1]), ok(0, "write", [1, 1]),
           inv(0, "cas", [None, [2, 5]]), ok(0, "cas", [2, [2, 5]]))
    assert checked(VersionedRegister(), h2)["valid?"] is False


def test_mutex_model():
    h = H(inv(0, "acquire", None), ok(0, "acquire", None),
          inv(1, "acquire", None), ok(1, "acquire", None))
    assert checked(Mutex(), h)["valid?"] is False
    h2 = H(inv(0, "acquire", None), ok(0, "acquire", None),
           inv(0, "release", None), ok(0, "release", None),
           inv(1, "acquire", None), ok(1, "acquire", None))
    assert checked(Mutex(), h2)["valid?"] is True


def test_cas_register_interleaving():
    h = H(inv(0, "write", 1), ok(0, "write", 1),
          inv(1, "read", None), inv(2, "write", 2),
          ok(2, "write", 2), ok(1, "read", 2))
    assert checked(CASRegister(), h)["valid?"] is True


# ---- the restored checker API ----------------------------------------------

STALE = (inv(0, "write", [None, 3]), ok(0, "write", [1, 3]),
         inv(0, "write", [None, 4]), ok(0, "write", [2, 4]),
         inv(0, "read", [None, None]), ok(0, "read", [1, 3]))
CLEAN = STALE[:4] + (inv(0, "read", [None, None]), ok(0, "read", [2, 4]))


@pytest.mark.parametrize("ops", [CLEAN, STALE], ids=["clean", "stale"])
def test_linearizable_checker_matches_reference(ops):
    h = H(*ops)
    ref_h = RefHistory.from_jsonl(h.to_jsonl())
    got = LinearizableChecker(VersionedRegister).check({}, h)
    want = RefLinearizableChecker(RefVR).check({}, ref_h)
    assert as_json(got) == as_json(want)
    assert got["valid?"] is (ops is CLEAN)
    small = linearizable(VersionedRegister)
    assert isinstance(small, LinearizableChecker)
    assert small.max_configs == 5_000_000
    assert as_json(small.check({}, h)) == \
        as_json(ref_linearizable(RefVR).check({}, ref_h))
    capped = LinearizableChecker(VersionedRegister, max_configs=1)
    assert as_json(capped.check({}, h)) == as_json(
        RefLinearizableChecker(RefVR, max_configs=1).check({}, ref_h))


@pytest.mark.parametrize("ops", [CLEAN, STALE], ids=["clean", "stale"])
def test_tpu_linearizable_matches_reference(ops, monkeypatch):
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    h = H(*ops)
    ref_h = RefHistory.from_jsonl(h.to_jsonl())
    got = tpu_linearizable(device="cpu")
    assert isinstance(got, TPULinearizableChecker)
    assert str(got.device) == "cpu"
    assert as_json(got.check({}, h)) == \
        as_json(ref_tpu_linearizable().check({}, ref_h))
    # a model factory of the caller's, and the kernel route pinned
    pinned = tpu_linearizable(lambda: VersionedRegister(0, None),
                              device="cpu")
    pinned.cpu_cutoff = None
    ref_pinned = ref_tpu_linearizable(lambda: RefVR(0, None))
    ref_pinned.cpu_cutoff = None
    out = pinned.check({}, h)
    assert as_json(out) == as_json(ref_pinned.check({}, ref_h))
    assert out["valid?"] is (ops is CLEAN)


def test_tpu_linearizable_needs_a_device_here():
    """Without a card, the factory at its default device raises, as
    the class does: the port never moves to the CPU on its own."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(Exception):
        tpu_linearizable()


# ---- the session write count follows the history's representation ---------

SESSION_OPS = [dict(op, time=t) for t, op in enumerate([
    # key 0: a write and a read; key 1: one write, no read (a key the
    # time limit cut after its first op)
    {"type": "invoke", "process": 0, "f": "write", "value": (0, [None, 2])},
    {"type": "ok", "process": 0, "f": "write", "value": (0, [1, 2])},
    {"type": "invoke", "process": 1, "f": "read", "value": (0, [None, None])},
    {"type": "ok", "process": 1, "f": "read", "value": (0, [1, 2])},
    {"type": "invoke", "process": 2, "f": "write", "value": (1, [None, 3])},
    {"type": "ok", "process": 2, "f": "write", "value": (1, [1, 3])},
])]


def _session_writes(pkg):
    """Key 1's session dict from the register workload's checker, on
    the history as dicts and as columns."""
    hist = mod(pkg, "core.history")
    h = hist.History([mod(pkg, "core.op").Op(o) for o in SESSION_OPS])
    cols = hist.columns_of(h.ops)
    assert cols is not None
    as_cols = hist.History.from_columns(cols)
    opts = {"nodes": ["n1"]}
    if pkg == PORT:
        opts["device"] = "cpu"
    checker = mod(pkg, "workloads").workloads()["register"](opts)["checker"]
    return [as_json(checker.check({}, x, {})["results"][1]["session"])
            for x in (h, as_cols)]


def test_session_write_count_follows_the_history_representation():
    """A key with a write and no read: the session checker counts its
    write on a column-backed history (the split keeps the run's f
    table, which has ``read``) and not on a dict-backed one (the key's
    own f table has no ``read``, and ``_versions`` returns early). The
    reference does this; the port keeps it, so a recorded run's stored
    dict and a re-check of its history.jsonl can differ in this one
    count in both packages."""
    got = _session_writes(PORT)
    assert got == _session_writes(REF)
    dicts, cols = got
    assert dicts == {"valid?": True, "sessions": 0, "reads": 0,
                     "writes": 0}
    assert cols == dict(dicts, writes=1)
