"""The port's capacity ladder, spill BFS and ``check_prefix`` against the
JAX package's, on the same packed histories (the port on the CPU, the
reference's jnp ladder on the CPU jax backend).

Equality is exact: verdict dicts (``_resume`` dropped), ``waves``,
``peak-frontier``, ``rungs``, spill ``states``, and the frozen frontier's
bytes at every ``check_prefix`` pause."""

import json
import random

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.checkers.tpu_linearizable import \
    TPULinearizableChecker as RefChecker
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
    TPULinearizableChecker
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.testing import concurrent_writes_history, \
    gen_history as port_gen_history, impossible_read_at

from test_wgl import _concurrent_writes_history, gen_history
from test_torch_fixtures import one_torch_thread  # noqa: F401


#: gen_history shapes whose packs land at each window width
SHAPES = {32: dict(n_procs=4, n_ops=30),
          64: dict(n_procs=16, n_ops=80, dur_scale=20.0),
          128: dict(n_procs=34, n_ops=130, dur_scale=30.0)}

BUDGETS = (1, 7, 64, 10 ** 6)


def port(h) -> History:
    return History.from_jsonl(h.to_jsonl())


def strip(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "_resume"}


def fuzz(w: int, info: bool, corrupt: bool, seed: int, n: int = 3):
    """n (reference history, reference pack) pairs whose packs take the
    ladder at window width w."""
    rng = random.Random(seed)
    got = []
    for _ in range(400):
        h = gen_history(rng, corrupt=corrupt,
                        info_rate=0.2 if info else 0.0, **SHAPES[w])
        p = ref_wgl.pack_register_history(h)
        if p.ok and p.w == w and (p.I > 0) == info:
            got.append((h, p))
        if len(got) == n:
            return got
    raise AssertionError(f"fuzz found {len(got)} w={w} info={info} packs")


def test_constants_match_reference():
    for name in ("F_MAX", "F_MAX_BIG", "LADDER", "SENTINEL_D",
                 "SENTINEL_W", "SENTINEL_V", "SPILL_CHUNK",
                 "SPILL_FRONTIER_LIMIT", "SPILL_STATE_BUDGET",
                 "SPILL_I_LIMIT", "SPILL_STATE_BUDGET_HIGH_I",
                 "SPILL_WALL_BUDGET_S"):
        assert getattr(wgl, name) == getattr(ref_wgl, name), name


@pytest.mark.parametrize("info", [False, True])
def test_pad_tables_and_info_dims_match_reference(info):
    for h, rp in fuzz(32, info, False, seed=50 + info):
        pp = wgl.pack_register_history(port(h))
        assert wgl.info_dims(pp) == ref_wgl.info_dims(rp)
        r_pad = wgl.bucket(pp.R)
        got = wgl.pad_tables(pp, r_pad)
        ref = ref_wgl.pad_tables(rp, r_pad)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            assert np.array_equal(got[k], ref[k]), k
        # rows past R are padded with a +inf ceiling, not 0
        assert (got["ceil_beyond"][pp.R:] == 2 ** 30).all()


@pytest.mark.parametrize("w", [32, 64, 128])
@pytest.mark.parametrize("info,corrupt", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_ladder_matches_reference_on_fuzz(w, info, corrupt):
    for h, rp in fuzz(w, info, corrupt, seed=1000 * w + 10 * info + corrupt,
                      n=2):
        pp = wgl.pack_register_history(port(h))
        ref = strip(ref_wgl.check_packed(rp, f_max=32))
        got = strip(wgl.check_packed(pp, f_max=32, device="cpu"))
        assert got == ref


def test_ladder_climbs_rungs_like_the_reference():
    """A history whose frontier passes the bottom rung resumes its
    frozen frontier rung by rung, with the reference's counters."""
    rng = random.Random(31)
    climbed = 0
    for _ in range(60):
        h = gen_history(rng, n_procs=10, n_ops=60, values=4,
                        info_rate=0.25, dur_scale=6.0)
        rp = ref_wgl.pack_register_history(h)
        if not rp.ok:
            continue
        ref = strip(ref_wgl.check_packed(rp, f_max=32))
        got = strip(wgl.check_packed(wgl.pack_register_history(port(h)),
                                     f_max=32, device="cpu"))
        assert got == ref
        climbed += ref["rungs"] >= 2
        if climbed >= 2:
            return
    raise AssertionError("no rung-climbing history found")


@pytest.mark.parametrize("seed", [2026, 7])
def test_wave_kernel_overflow_restarts_the_ladder_like_the_reference(seed):
    """The ladder's route at real size, cut to 800 ops: 8 processes
    overflow the wave kernel's 32 slots, and an impossible read late in
    the history keeps it from accepting, so the port restarts the ladder
    at rung 32 and ends on the reference's dict (which, off the TPU,
    climbs the ladder from the start)."""
    h = impossible_read_at(port_gen_history(random.Random(seed), n_procs=8,
                                            n_ops=800), 0.9)
    pp = wgl.pack_register_history(h)
    rp = ref_wgl.pack_register_history(RefHistory.from_jsonl(h.to_jsonl()))
    assert wgl_mxu.check_packed_mxu(pp, device="cpu")["overflow"]
    got = wgl.check_packed(pp, device="cpu")
    assert strip(got) == strip(ref_wgl.check_packed(rp))
    assert got["engine"] == "jnp-ladder" and got["valid?"] is False


@pytest.mark.cuda
def test_graph_replayed_waves_equal_the_eager_loop(monkeypatch):
    """On the card, long rungs replay their waves from a CUDA graph:
    the same operations, so the same dict as one launch per
    operation."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    h = impossible_read_at(port_gen_history(random.Random(2026), n_procs=8,
                                            n_ops=1500), 0.9)
    p = wgl.pack_register_history(h)
    graphed = wgl.check_packed(p, f_max=32)
    assert graphed["waves"] > wgl.GRAPH_MIN_WAVES
    monkeypatch.setattr(wgl, "GRAPH_MIN_WAVES", 1 << 62)
    assert wgl.check_packed(p, f_max=32) == graphed


def test_concurrent_writes_history_matches_reference_helper():
    for n in (4, 12, 16):
        for rv in (1, 9):
            assert concurrent_writes_history(n, read_val=rv).to_jsonl() == \
                _concurrent_writes_history(n, read_val=rv).to_jsonl()


@pytest.mark.parametrize("n", [12, 16])
@pytest.mark.parametrize("read_val", [1, 9])
def test_spill_matches_reference(n, read_val):
    """n=12 settles on the ladder (peak 924); n=16 (peak C(16,8) =
    12,870) passes the top rung and the spill BFS answers."""
    h = _concurrent_writes_history(n, read_val=read_val)
    ref = strip(ref_wgl.check_packed(ref_wgl.pack_register_history(h),
                                     f_max=32))
    got = strip(wgl.check_packed(wgl.pack_register_history(port(h)),
                                 f_max=32, device="cpu"))
    assert got == ref
    assert got["valid?"] is (read_val == 1)
    assert got.get("spilled", False) is (n == 16)


@pytest.mark.parametrize("read_val", [1, 9])
def test_spill_false_hands_back_the_frozen_frontier(read_val):
    """spill=False returns the reference's overflow dict; resuming its
    payload through spill_packed gives the one-shot spill verdict."""
    h = _concurrent_writes_history(16, read_val=read_val)
    rp = ref_wgl.pack_register_history(h)
    pp = wgl.pack_register_history(port(h))
    ref = ref_wgl.check_packed(rp, f_max=32, spill=False)
    got = wgl.check_packed(pp, f_max=32, spill=False, device="cpu")
    assert strip(got) == strip(ref)
    assert got["overflow"] is True
    tables, frontier, k = got["_resume"]
    assert k == ref["_resume"][2]
    assert frontier_bytes(frontier) == ref_frontier_bytes(
        ref["_resume"][1])
    assert wgl.spill_packed(pp, *got["_resume"]) == \
        ref_wgl.spill_packed(rp, *ref["_resume"])


@pytest.mark.parametrize("f_max", [None, 32])
@pytest.mark.parametrize("read_val", [1, 9])
def test_checker_without_fallback_spills_like_the_reference(read_val,
                                                            f_max):
    """With f_max=32 both checkers skip the wave kernel and spill. With
    the default the port's wave kernel goes first (the reference skips
    it off the TPU): a witness it finds within its 32 slots answers
    True, and an overflow climbs the ladder and spills as the
    reference does."""
    h = _concurrent_writes_history(16, read_val=read_val)
    ref = RefChecker(fallback=False, f_max=f_max).check({}, h)
    got = TPULinearizableChecker(fallback=False, f_max=f_max,
                                 device="cpu").check({}, port(h))
    assert got["valid?"] is ref["valid?"] is (read_val == 1)
    if got["engine"] == "mxu-wave":
        assert f_max is None and read_val == 1
        return
    for k in ("valid?", "spilled", "rungs", "peak-frontier", "engine",
              "checker", "waves", "states"):
        assert got.get(k) == ref.get(k), (k, got, ref)
    assert got["spilled"] is True


def test_checker_without_fallback_matches_reference_on_fuzz():
    """On the CPU the reference skips the wave kernel and the port runs
    its plain version first: engines are compared only where the wave
    kernel did not answer."""
    seen = set()
    for w, info, corrupt in [(32, False, False), (32, True, True),
                             (64, False, True), (64, True, False)]:
        for h, _ in fuzz(w, info, corrupt, seed=77 + w + info, n=2):
            ref = RefChecker(fallback=False).check({}, h)
            got = TPULinearizableChecker(fallback=False,
                                         device="cpu").check({}, port(h))
            seen.add(got.get("engine"))
            assert got["valid?"] == ref["valid?"]
            if got.get("engine") != "mxu-wave":
                for k in ("engine", "rungs", "peak-frontier", "waves"):
                    assert got.get(k) == ref.get(k), (k, got, ref)
    assert {"mxu-wave", "jnp-ladder"} <= seen


# -- check_prefix -------------------------------------------------------

def frontier_bytes(fr):
    """A port frontier in the reference's dtypes, as bytes, and n_alive."""
    d, w, i, v, n = fr
    return (d.numpy().astype(np.int32).tobytes()
            + w.numpy().astype(np.uint32).tobytes()
            + i.numpy().astype(np.uint32).tobytes()
            + v.numpy().astype(np.int32).tobytes(), int(n))


def ref_frontier_bytes(fr):
    d, w, i, v, n = (np.asarray(x) for x in fr)
    assert (d.dtype, w.dtype, i.dtype, v.dtype) == \
        (np.int32, np.uint32, np.uint32, np.int32)
    return d.tobytes() + w.tobytes() + i.tobytes() + v.tobytes(), int(n)


def _prefix_histories():
    out = []
    for seed in (7, 21, 404):                 # tests/test_stream.py cases
        rng = random.Random(seed)
        out.append(gen_history(rng, n_procs=rng.randint(3, 6),
                               n_ops=rng.randint(16, 48),
                               info_rate=0.1 if seed % 2 else 0.0))
    rng = random.Random(31)                   # a rung-escalating one
    for _ in range(60):
        h = gen_history(rng, n_procs=10, n_ops=60, values=4,
                        info_rate=0.25, dur_scale=6.0)
        p = ref_wgl.pack_register_history(h)
        if p.ok and ref_wgl.check_packed(p).get("rungs", 1) >= 2:
            out.append(h)
            break
    out.append(_concurrent_writes_history(12, read_val=9))
    return out


@pytest.mark.parametrize("budget", BUDGETS)
def test_check_prefix_matches_reference_at_every_pause(budget):
    for h in _prefix_histories():
        rp = ref_wgl.pack_register_history(h)
        pp = wgl.pack_register_history(port(h))
        rs = ps = None
        pauses = 0
        while True:
            rs = ref_wgl.check_prefix(rp, rs, max_waves=budget)
            ps = wgl.check_prefix(pp, ps, max_waves=budget, device="cpu")
            pauses += 1
            assert ps.done == rs.done
            assert (ps.k, ps.rungs, ps.rung_i, ps.peak, ps.waves_run) == \
                (int(rs.k), rs.rungs, rs.rung_i, rs.peak, rs.waves_run)
            if ps.done:
                break
            assert frontier_bytes(ps.frontier) == \
                ref_frontier_bytes(rs.frontier)
            assert pauses < 10_000
        assert json.dumps(strip(ps.result), sort_keys=True) == \
            json.dumps(strip(rs.result), sort_keys=True)
        # and the one-shot ladder ends on the same dict
        assert strip(wgl.check_packed(pp, f_max=32, device="cpu")) == \
            strip(ps.result)


def test_check_prefix_spills_like_the_reference():
    h = _concurrent_writes_history(16, read_val=1)
    rp = ref_wgl.pack_register_history(h)
    pp = wgl.pack_register_history(port(h))
    rs = ps = None
    while ps is None or not ps.done:
        rs = ref_wgl.check_prefix(rp, rs, max_waves=64)
        ps = wgl.check_prefix(pp, ps, max_waves=64, device="cpu")
    assert ps.result == rs.result
    assert ps.result["spilled"] is True and ps.result["valid?"] is True


def test_check_prefix_trivial_and_unpackable():
    empty = wgl.pack_register_history(History([]))
    state = wgl.check_prefix(empty, device="cpu")
    assert state.done and state.result == {"valid?": True, "waves": 0}
    bad = wgl.Packed(ok=False, reason="delegated")
    state = wgl.check_prefix(bad, device="cpu")
    assert state.done
    assert state.result == {"valid?": "unknown", "reason": "delegated",
                            "blowup": False}


@pytest.mark.parametrize("sync_every", [3, 8, 1000])
def test_wave_loop_host_sync_cadence_leaves_results_unchanged(
        sync_every, monkeypatch):
    """Waves past the end are masked no-ops, so how often the host reads
    the loop condition never changes the loop's outputs."""
    h = _concurrent_writes_history(12, read_val=9)
    p = wgl.pack_register_history(port(h))
    cpu = wgl.resolve_device("cpu")
    tables = wgl.device_tables(p, cpu)
    for f, k_stop in [(128, None), (1024, None), (1024, 5)]:
        init = (0, *wgl._initial_frontier(f, 1, 0, cpu))
        monkeypatch.setattr(wgl, "SYNC_EVERY", 1)
        base = wgl._wgl_loop(tables, p.R, p.I, f, p.w, init, k_stop)
        monkeypatch.setattr(wgl, "SYNC_EVERY", sync_every)
        got = wgl._wgl_loop(tables, p.R, p.I, f, p.w, init, k_stop)
        assert got[:4] == base[:4]
        assert frontier_bytes(got[4]) == frontier_bytes(base[4])
