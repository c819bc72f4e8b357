"""Twin of the reference's ``tests/test_native_oracle.py`` on the port:
the port's native C++ WGL oracle (``native/oracle.py`` over its copy of
``wgl_oracle.cpp``) against its Python DFS, with the reference's
assertions, and each check's dict equal to the reference's on the same
history. ``test_kill_switch`` holds ``JEPSEN_ETCD_TPU_NO_NATIVE``: the
port's ``get_lib`` gives None with it set, checked before the memo, and
its dict is the reference's."""

import random

import pytest

from jepsen_etcd_tpu.checkers.linearizable import \
    check_history as ref_check_history
from jepsen_etcd_tpu.checkers.tpu_linearizable import \
    TPULinearizableChecker as RefTPULinearizableChecker
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.models import CASRegister as RefCASRegister
from jepsen_etcd_tpu.models import Mutex as RefMutex
from jepsen_etcd_tpu.models import VersionedRegister as RefVR
from jepsen_etcd_tpu.native import oracle as ref_native
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu_torch.checkers.linearizable import (check_history,
                                                         history_entries)
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.models import VersionedRegister, Mutex, \
    CASRegister
from jepsen_etcd_tpu_torch.native import oracle as native
from jepsen_etcd_tpu_torch.testing import gen_history, gen_mutex_history
from test_torch_fixtures import as_json, one_torch_thread  # noqa: F401

import test_wgl

#: the port's models by the reference's, for a history checked by both
REF_MODEL = {VersionedRegister: RefVR, Mutex: RefMutex,
             CASRegister: RefCASRegister}


def ref_of(h) -> RefHistory:
    return RefHistory.from_jsonl(h.to_jsonl())


def checked(model, h, **kw) -> dict:
    """The port's ``check_history`` dict, held equal to the
    reference's on the same history."""
    got = check_history(model, h, **kw)
    ref_model = REF_MODEL[type(model)](*_model_args(model))
    assert as_json(got) == as_json(ref_check_history(ref_model, ref_of(h),
                                                     **kw))
    return got


def _model_args(model) -> tuple:
    if isinstance(model, VersionedRegister):
        return (model.version, model.value)
    return ()


def test_gen_mutex_history_matches_reference_helper():
    for seed in range(6):
        kw = dict(n_procs=3, n_ops=18, corrupt=seed % 2 == 1,
                  info_rate=0.25 if seed % 3 == 0 else 0.0)
        got = gen_mutex_history(random.Random(seed), **kw)
        want = test_wgl.gen_mutex_history(random.Random(seed), **kw)
        assert got.to_jsonl() == want.to_jsonl()


def test_native_lib_builds():
    assert native.get_lib() is not None, \
        "g++ is baked into the image; the native oracle must build"


@pytest.mark.parametrize("corrupt,info_rate",
                         [(False, 0.0), (True, 0.0),
                          (False, 0.25), (True, 0.25)])
def test_differential_register(corrupt, info_rate):
    rng = random.Random(hash(("native", corrupt, info_rate)) & 0xFFFF)
    for trial in range(120):
        h = gen_history(rng, n_procs=rng.randint(2, 5),
                        n_ops=rng.randint(8, 32), corrupt=corrupt,
                        info_rate=info_rate)
        nat = checked(VersionedRegister(), h)
        py = check_history(VersionedRegister(), h, use_native=False)
        assert nat.get("checker-impl") == "native"
        assert nat["valid?"] == py["valid?"], (
            f"trial {trial}: native={nat} python={py['valid?']}\n"
            + h.to_jsonl())


@pytest.mark.parametrize("corrupt,info_rate",
                         [(False, 0.0), (True, 0.0), (False, 0.25)])
def test_differential_mutex(corrupt, info_rate):
    rng = random.Random(hash(("native-mutex", corrupt, info_rate)) & 0xFFFF)
    for trial in range(100):
        h = gen_mutex_history(rng, n_procs=rng.randint(2, 4),
                              n_ops=rng.randint(6, 24),
                              corrupt=corrupt, info_rate=info_rate)
        nat = checked(Mutex(), h)
        py = check_history(Mutex(), h, use_native=False)
        assert nat.get("checker-impl") == "native"
        assert nat["valid?"] == py["valid?"], (
            f"trial {trial}: native={nat} python={py['valid?']}\n"
            + h.to_jsonl())


def test_invalid_history_diagnostics():
    ops = [
        Op(type="invoke", process=0, f="write", value=[None, 1]),
        Op(type="ok", process=0, f="write", value=[1, 1]),
        Op(type="invoke", process=1, f="read", value=[None, None]),
        Op(type="ok", process=1, f="read", value=[1, 2]),
    ]
    out = checked(VersionedRegister(), History(ops))
    assert out.get("checker-impl") == "native"
    assert out["valid?"] is False
    assert "op" in out and "error" in out
    assert "read" in out["error"] or "can't" in out["error"]


def test_cas_register_adapter():
    ops = [
        Op(type="invoke", process=0, f="write", value="a"),
        Op(type="ok", process=0, f="write", value="a"),
        Op(type="invoke", process=1, f="cas", value=["a", "b"]),
        Op(type="ok", process=1, f="cas", value=["a", "b"]),
        Op(type="invoke", process=0, f="read", value=None),
        Op(type="ok", process=0, f="read", value="b"),
    ]
    out = checked(CASRegister(), History(ops))
    assert out.get("checker-impl") == "native"
    assert out["valid?"] is True
    bad = ops + [
        Op(type="invoke", process=0, f="read", value=None),
        Op(type="ok", process=0, f="read", value="z"),
    ]
    out = checked(CASRegister(), History(bad))
    assert out["valid?"] is False


def test_unsupported_model_returns_none():
    ops = [Op(type="invoke", process=0, f="read", value=[3, "x"]),
           Op(type="ok", process=0, f="read", value=[3, "x"])]
    ents = history_entries(History(ops))
    assert native.check_entries(VersionedRegister(3, "x"), ents) is None
    out = checked(VersionedRegister(3, "x"), History(ops))
    assert out["valid?"] is True
    assert "checker-impl" not in out


WRITE_ONLY = [
    {"type": "invoke", "process": 0, "f": "write", "value": [None, 1]},
    {"type": "ok", "process": 0, "f": "write", "value": [1, 1]},
]


def test_kill_switch(monkeypatch):
    monkeypatch.setenv("JEPSEN_ETCD_TPU_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert ref_native.get_lib() is None
    out = checked(VersionedRegister(), History([Op(o) for o in WRITE_ONLY]))
    assert out["valid?"] is True
    assert "checker-impl" not in out
    # the Python DFS takes every history the native engine would
    rng = random.Random(5)
    for _ in range(10):
        h = gen_history(rng, n_procs=3, n_ops=16, info_rate=0.2)
        assert "checker-impl" not in checked(VersionedRegister(), h)


def test_kill_switch_is_read_at_every_call(monkeypatch):
    """The variable is read before the memo: the library, once built,
    is hidden while it is set and comes back, the same object, once it
    is unset."""
    lib = native.get_lib()
    assert lib is not None
    monkeypatch.setenv("JEPSEN_ETCD_TPU_NO_NATIVE", "1")
    assert native.get_lib() is None
    monkeypatch.delenv("JEPSEN_ETCD_TPU_NO_NATIVE")
    assert native.get_lib() is lib
    out = checked(VersionedRegister(), History([Op(o) for o in WRITE_ONLY]))
    assert out.get("checker-impl") == "native"


def test_budget_exceeded_is_unknown():
    rng = random.Random(31)
    h = gen_history(rng, n_procs=6, n_ops=60, info_rate=0.4)
    out = checked(VersionedRegister(), h, max_configs=3)
    assert out.get("checker-impl") == "native"
    assert out["valid?"] in ("unknown", True)


@pytest.mark.parametrize("read_val,expect", [(1.0, True), ("1", False),
                                             (True, True)])
def test_value_equality_semantics(read_val, expect, monkeypatch):
    """Value-id equality is Python == (1 == 1.0 == True; '1' is not) on
    the native engine, the Python DFS and the wave kernel's route
    (``device="cpu"``: the port raises without a card), each dict equal
    to the reference's."""
    from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import (
        TPULinearizableChecker)
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    ops = [
        Op(type="invoke", process=0, f="write", value=[None, 1]),
        Op(type="ok", process=0, f="write", value=[1, 1]),
        Op(type="invoke", process=1, f="read", value=[None, None]),
        Op(type="ok", process=1, f="read", value=[1, read_val]),
    ]
    h = History(ops)
    nat = checked(VersionedRegister(), h)
    py = checked(VersionedRegister(), h, use_native=False)
    tpu = TPULinearizableChecker(fallback=True, device="cpu").check({}, h)
    ref_tpu = RefTPULinearizableChecker(fallback=True).check({}, ref_of(h))
    assert as_json(tpu) == as_json(ref_tpu)
    assert py["valid?"] is expect
    assert nat["valid?"] is expect
    assert tpu["valid?"] is expect


def test_nonint_version_assertion_falls_back_soundly():
    ops = [
        Op(type="invoke", process=0, f="write", value=[None, 1]),
        Op(type="ok", process=0, f="write", value=["x", 1]),
    ]
    h = History(ops)
    out = checked(VersionedRegister(), h)
    py = checked(VersionedRegister(), h, use_native=False)
    assert out["valid?"] is py["valid?"] is False
    from jepsen_etcd_tpu_torch.ops import wgl
    p = wgl.pack_register_history(h)
    assert not p.ok and "unsupported value" in p.reason
    assert p.reason == ref_wgl.pack_register_history(ref_of(h)).reason


def test_native_much_faster_on_deep_history():
    """The native engine beats the Python DFS on a mid-size history
    (an ordering assertion, not a benchmark)."""
    import time
    rng = random.Random(17)
    h = gen_history(rng, n_procs=8, n_ops=160, info_rate=0.1)
    native.get_lib()
    t0 = time.time()
    nat = check_history(VersionedRegister(), h)
    t_nat = time.time() - t0
    t0 = time.time()
    py = check_history(VersionedRegister(), h, use_native=False)
    t_py = time.time() - t0
    assert nat["valid?"] == py["valid?"]
    assert t_nat < t_py, f"native {t_nat:.3f}s vs python {t_py:.3f}s"
    assert as_json(nat) == as_json(ref_check_history(RefVR(), ref_of(h)))
