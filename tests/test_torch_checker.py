"""The port's checker, native oracle and history synthesizer against the
JAX package's, on the same histories (on the CPU: the port's checker
runs its wave search through the plain PyTorch version)."""

import random

import pytest
import torch

from jepsen_etcd_tpu.checkers.linearizable import \
    check_history as ref_check_history
from jepsen_etcd_tpu.checkers.tpu_linearizable import \
    TPULinearizableChecker as RefChecker
from jepsen_etcd_tpu.models import CASRegister as RefCAS
from jepsen_etcd_tpu.models import Mutex as RefMutex
from jepsen_etcd_tpu.models import VersionedRegister as RefVR
from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
    TPULinearizableChecker
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.models import CASRegister, Mutex, \
    VersionedRegister
from jepsen_etcd_tpu_torch.ops import wgl
from jepsen_etcd_tpu_torch.testing import gen_history as port_gen_history

from test_wgl import _concurrent_writes_history, gen_history, \
    gen_mutex_history
from test_torch_fixtures import one_torch_thread  # noqa: F401


def port(h) -> History:
    return History.from_jsonl(h.to_jsonl())


@pytest.mark.parametrize("seed", [1, 2026, 99])
def test_gen_history_matches_reference_helper(seed):
    kw = dict(n_procs=5, n_ops=60, corrupt=seed % 2 == 1, info_rate=0.1)
    ref = gen_history(random.Random(seed), **kw)
    got = port_gen_history(random.Random(seed), **kw)
    assert got.to_jsonl() == ref.to_jsonl()


@pytest.mark.parametrize("corrupt,info_rate",
                         [(False, 0.0), (True, 0.0), (False, 0.25),
                          (True, 0.25)])
def test_native_oracle_matches_reference(corrupt, info_rate):
    rng = random.Random(1000 * corrupt + int(100 * info_rate))
    for trial in range(25):
        h = gen_history(rng, n_procs=rng.randint(2, 5),
                        n_ops=rng.randint(8, 32), corrupt=corrupt,
                        info_rate=info_rate)
        ref = ref_check_history(RefVR(), h)
        got = check_history(VersionedRegister(), port(h))
        assert got.get("checker-impl") == "native"
        assert got == ref, (trial, got, ref)
        py = check_history(VersionedRegister(), port(h), use_native=False)
        assert py["valid?"] == got["valid?"]


def test_native_oracle_mutex_and_cas_register_match_reference():
    rng = random.Random(12)
    for trial in range(20):
        h = gen_mutex_history(rng, n_procs=3, n_ops=18,
                              corrupt=trial % 2 == 1,
                              info_rate=0.2 if trial % 4 == 0 else 0.0)
        assert check_history(Mutex(), port(h)) == \
            ref_check_history(RefMutex(), h)
    ops = [
        {"type": "invoke", "process": 0, "f": "write", "value": "a"},
        {"type": "ok", "process": 0, "f": "write", "value": "a"},
        {"type": "invoke", "process": 1, "f": "cas", "value": ["a", "b"]},
        {"type": "ok", "process": 1, "f": "cas", "value": ["a", "b"]},
        {"type": "invoke", "process": 0, "f": "read", "value": None},
        {"type": "ok", "process": 0, "f": "read", "value": "b"},
    ]
    for extra in ([], [{"type": "invoke", "process": 0, "f": "read",
                        "value": None},
                       {"type": "ok", "process": 0, "f": "read",
                        "value": "z"}]):
        from jepsen_etcd_tpu.core.history import History as RefHistory
        rh = RefHistory(ops + extra)
        assert check_history(CASRegister(), port(rh)) == \
            ref_check_history(RefCAS(), rh)


@pytest.mark.parametrize("corrupt,info_rate,n_ops",
                         [(False, 0.0, 40), (True, 0.0, 40),
                          (False, 0.2, 40), (True, 0.2, 300)])
def test_default_routing_matches_reference(corrupt, info_rate, n_ops):
    """With the default routing both checkers answer these histories
    with the DFS (size cutoff, or the DFS-first band past 512
    entries): same verdict, same checker and engine-route labels."""
    rng = random.Random(n_ops * 10 + corrupt)
    ref_c = RefChecker()
    got_c = TPULinearizableChecker(device="cpu")
    for trial in range(6):
        h = gen_history(rng, n_procs=4, n_ops=n_ops, corrupt=corrupt,
                        info_rate=info_rate)
        ref = ref_c.check({}, h)
        got = got_c.check({}, port(h))
        assert got["valid?"] == ref["valid?"]
        assert ref["checker"] == "cpu-oracle"
        for k in ("checker", "engine-route"):
            assert got.get(k) == ref.get(k), (k, got, ref)


def test_kernel_route_verdicts_match_reference():
    """With the size cutoff off, the port answers through the wave
    search and the reference through its jnp ladder (off the TPU):
    every definitive port verdict equals the reference's."""
    rng = random.Random(31)
    ref_c = RefChecker(cpu_cutoff=None)
    got_c = TPULinearizableChecker(cpu_cutoff=None, device="cpu")
    engines = set()
    for trial in range(8):
        h = gen_history(rng, n_procs=3, n_ops=24, corrupt=trial % 2 == 1)
        got = got_c.check({}, port(h))
        engines.add(got.get("engine"))
        assert got["valid?"] == ref_c.check({}, h)["valid?"]
        assert got["valid?"] == check_history(VersionedRegister(),
                                              port(h))["valid?"]
    assert "mxu-wave" in engines


@pytest.mark.parametrize("read_val,f_max", [(1, 32), (9, None), (9, 32)])
def test_overflow_past_the_dfs_spills_like_the_reference(monkeypatch,
                                                         read_val, f_max):
    """Past the ladder's top rung the DFS goes first; when it exhausts
    its budget the spill BFS resumes the frozen frontier and gives the
    reference's definite verdict. (A witness within the wave kernel's
    32 slots answers before any overflow, so the valid case starts the
    ladder at f_max=32, as the reference does off the TPU.)"""
    rh = _concurrent_writes_history(16, read_val=read_val)
    ref_c = RefChecker(cpu_cutoff=None, f_max=f_max)
    got_c = TPULinearizableChecker(cpu_cutoff=None, f_max=f_max,
                                   device="cpu")
    for c in (ref_c, got_c):
        monkeypatch.setattr(c, "FALLBACK_MAX_CONFIGS", 1)
    ref = ref_c.check({}, rh)
    got = got_c.check({}, port(rh))
    assert got == ref
    assert got["valid?"] is (read_val == 1)
    assert got["spilled"] is True and got["checker"] == "tpu-wgl"
    # with a DFS budget that suffices, the DFS answers as in the reference
    for c in (ref_c, got_c):
        monkeypatch.setattr(c, "FALLBACK_MAX_CONFIGS", 5_000_000)
    ref = ref_c.check({}, rh)
    got = got_c.check({}, port(rh))
    assert got["valid?"] == ref["valid?"] is (read_val == 1)
    assert got["checker"] == ref["checker"] == "cpu-oracle"
    assert got["tpu-fallback-reason"] == ref["tpu-fallback-reason"]


def test_info_op_histories_route_like_the_reference():
    """Info ops are outside the wave kernel: past the band they go
    DFS-first ("info-dfs-first"), as in the reference."""
    rng = random.Random(8)
    h = gen_history(rng, n_procs=4, n_ops=30, info_rate=0.3)
    assert wgl.pack_register_history(port(h)).I > 0
    ref = RefChecker(cpu_cutoff=1, dfs_first_max=1).check({}, h)
    got = TPULinearizableChecker(cpu_cutoff=1, dfs_first_max=1,
                                 device="cpu").check({}, port(h))
    assert got["valid?"] == ref["valid?"]
    assert got["engine-route"] == "info-dfs-first"
    for k in ("checker", "engine-route"):
        assert got.get(k) == ref.get(k)
