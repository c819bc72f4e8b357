"""A numpy model of ``csrc/wgl_rung.cu``, warp by warp and lane by lane,
held after EVERY wave against the plain version, ``_expand`` /
``_wgl_loop`` run a wave at a time.

The kernel has no CPU mode, so its design is checked here. The model
reads the int32 tables the card builds for it (``wgl.card_tables``,
with csrc/wgl_frames.cu's own model, ``frames_launch``, in its launch's
place) and writes what the kernel writes, so it stands in for the
launch (``_cuda.wgl_rung``) behind the real wrapper
``_rung_kernel_loop``: the route, the tables and the frontier's round
trip are the program's own. Its steps, as the model writes them:

- expansion: warp w takes states s = w + 32 t; a state that is a
  sentinel, at depth >= R, or whose version passes the least ceiling of
  its unlinearized ops (two warp reductions) adds nothing; else lane j
  tests op j (static, not set, predecessors in, version, model, slide)
  and lane c class c (can fire more, static, member predecessors in,
  model, the child's ceiling). The warp's valid candidates append as
  key words (d, mask word, count words, v; d and v biased by 2**31), its
  ops in lane order, then its classes;
- dedupe: each candidate is inserted into an open-addressing set of
  twice the wave's largest candidate count, with the kernel's hash and
  linear probing; an insert into an empty slot is a distinct candidate,
  and their number is n_new (the kernel inserts from all warps at once:
  any order gives the same set and count);
- ranks: a distinct candidate's rank is the number of distinct
  candidates below it in unsigned key order; unless the wave overflows
  (n_new > F, not accepted: the frontier stays), ranks below F are the
  next frontier's rows and sentinel rows follow;
- stop tests: accepted, a dead frontier, overflow, k == lim.

After every wave the frontier rows, n_new, acceptance, overflow, k,
peak and n_alive must equal the plain loop's, tolerance 0: on
``tests/test_torch_wgl_ladder.py``'s fuzz at w = 32 with and without
info ops and corruption, on searches that overflow and climb the
ladder (a lone ladder 32 -> 128 -> 256 -> ..., a batched rung at 128
whose key climbs from 512), on batched groups, and at every pause of
its ``BUDGETS``.
"""

import contextlib
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu_torch.ops import _cuda, wgl
from jepsen_etcd_tpu_torch.testing import gen_history

from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_wgl_ladder import BUDGETS, _prefix_histories, \
    frontier_bytes, fuzz, port, strip
from test_wgl import _concurrent_writes_history

M32 = 0xFFFFFFFF
BIAS = 0x80000000
SENT_D = 2 ** 31 - 1
EMPTY = 0xFFFF
W = 32
LANE = np.arange(W, dtype=np.int64)
# a depth's row and a class's row, as the kernel reads them
T_FSK, T_A1, T_A2, T_VER, T_PRED, T_CEIL = 0, W, 2 * W, 3 * W, 4 * W, 5 * W
T_SHIFT, T_UF, T_CEILB, T_UPD = 6 * W, 6 * W + 1, 6 * W + 2, 6 * W + 3
K_F, K_A1, K_A2, K_SIZE, K_OFF, K_WORD, K_SHIFT, K_MASK, K_INC = range(9)
CEIL_INF = 2 ** 30
NO_ASSERT = -(2 ** 30)
CPU = torch.device("cpu")


def kernel_limits() -> tuple:
    """F_CAP, C_CAP and NI_CAP as csrc/wgl_rung.cu states them: what
    ``_cuda.wgl_rung_limits`` reads from the built kernel on the card."""
    src = (Path(wgl.__file__).parents[1] / "csrc" / "wgl_rung.cu") \
        .read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
                 for name in ("F_CAP", "C_CAP", "NI_CAP"))


def signed(x):
    """uint32 words (int64 arrays) as int32 values."""
    return np.where(x >= 2 ** 31, x - 2 ** 32, x)


def layout(f: int, c_pad: int) -> tuple:
    """The kernel's (cap, hsize): the candidates a wave can have, and
    the set's slots, a power of two at least twice that."""
    cap = f * (W + c_pad)
    hsize = 64
    while hsize < 2 * cap:
        hsize *= 2
    return cap, hsize


def hash_key(key: tuple) -> int:
    """The kernel's ``hash_key``."""
    h = 0x9E3779B9
    for q in key:
        h ^= q
        h = (h * 0x85EBCA6B) & M32
        h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def expand_state(key, rows, info, cl, c_pad, i_tab, R, ni):
    """One warp's work on one frontier state: None when it adds nothing,
    else (its candidates' keys, ops in lane order then classes, and
    whether an op reached depth R)."""
    d = int(signed(np.int64(key[0] ^ BIAS)))
    if d == SENT_D or d >= R:
        return None
    w = int(key[1])
    iw = [int(x) for x in key[2:2 + ni]]
    v = int(signed(np.int64(key[-1] ^ BIAS)))
    row = rows[d]
    fsk, a1, a2 = (row[T_FSK:T_FSK + W], row[T_A1:T_A1 + W],
                   row[T_A2:T_A2 + W])
    rver, ceil = row[T_VER:T_VER + W], row[T_CEIL:T_CEIL + W]
    pred = row[T_PRED:T_PRED + W] & M32
    shift, uf, ceilb = int(row[T_SHIFT]), int(row[T_UF]), int(row[T_CEILB])
    upd = int(row[T_UPD]) & M32
    has = LANE < c_pad
    # lane c's count of class c; the warp's sum is the info total
    word = np.array([iw[int(cl[c, K_WORD])] if has[c] else 0
                     for c in range(W)], np.int64)
    cnt = np.where(has, (word >> cl[:, K_SHIFT]) & (cl[:, K_MASK] & M32), 0)
    version = uf + bin(w & upd).count("1") + int(cnt.sum())
    not_set = ((w >> LANE) & 1) == 0
    min_ceil = min(int(np.where(not_set, ceil, CEIL_INF).min()), ceilb)
    if version > min_ceil:
        return None
    # lane j: op j
    is_read, is_write, is_cas = fsk == 1, fsk == 2, fsk == 3
    ver_ok = (rver == NO_ASSERT) | (rver == np.where(is_read, version,
                                                     version + 1))
    model_ok = (is_read & ((a1 == -1) | (a1 == v))) | is_write | \
        (is_cas & (a1 == v))
    nwv = w | (1 << LANE)
    low = 0 if shift <= 0 else (M32 if shift >= 32 else (1 << shift) - 1)
    valid = (fsk > 0) & not_set & ((w & pred) == pred) & ver_ok & \
        model_ok & ((nwv & low) == low)
    child_w = nwv >> shift if 0 <= shift < 32 else np.zeros_like(nwv)
    nv = np.where(is_read, v, np.where(is_write, a1, a2))
    out = [((d + 1) ^ BIAS, int(child_w[j]), *iw, (int(nv[j]) & M32) ^ BIAS)
           for j in LANE[valid]]
    accept = bool(valid.any()) and d + 1 == R
    # lane c: class c fires its next member
    for c in range(c_pad):
        if cnt[c] >= cl[c, K_SIZE]:
            continue
        member = min(max(int(cl[c, K_OFF] + cnt[c]), 0), i_tab - 1)
        ip = int(info[d, member]) & M32
        cf = int(cl[c, K_F])
        if (info[d, i_tab + member] != 0 and (w & ip) == ip
                and (cf == wgl.WRITE or (cf == wgl.CAS
                                         and cl[c, K_A1] == v))
                and version + 1 <= min_ceil):
            nv_c = cl[c, K_A1] if cf == wgl.WRITE else cl[c, K_A2]
            out.append((d ^ BIAS, w,
                        *[(iw[q] + int(cl[c, K_INC + q])) & M32
                          for q in range(ni)],
                        (int(nv_c) & M32) ^ BIAS))
    return out, accept


def dedupe(cand: list, hsize: int) -> list:
    """The distinct candidates' indices, in the order their inserts
    claimed an empty slot of the open-addressing set."""
    slots = [EMPTY] * hsize
    mask = hsize - 1
    uniq = []
    for x, key in enumerate(cand):
        h = hash_key(key) & mask
        while True:
            if slots[h] == EMPTY:
                slots[h] = x
                uniq.append(x)
                break
            if cand[slots[h]] == key:
                break
            h = (h + 1) & mask
    return uniq


def ranks(keys: np.ndarray) -> np.ndarray:
    """[n, KW] distinct key words -> each row's count of rows below it
    in unsigned lexicographic order (a warp a row, its lanes counting)."""
    out = np.zeros(len(keys), np.int64)
    for a in range(0, len(keys), 256):
        blk = keys[a:a + 256]
        below = np.zeros((len(blk), len(keys)), bool)
        eq = np.ones_like(below)
        for q in range(keys.shape[1]):
            x, y = blk[:, q, None], keys[None, :, q]
            below |= eq & (y < x)
            eq &= y == x
        out[a:a + 256] = below.sum(1)
    return out


def unbias(fr: np.ndarray) -> np.ndarray:
    """[KW, F] key words -> [F, KW] int64 rows (d, mask, counts, v)."""
    out = fr.T.copy()
    out[:, 0] = signed(fr[0] ^ BIAS)
    out[:, -1] = signed(fr[-1] ^ BIAS)
    return out


def rung_model(rows, info, cls, fr_in, n_alive, R, k0, lim):
    """The kernel's rung run: (frontier [F, KW] int64, res [5]: accepted,
    overflow, k, peak, n_alive, and the state after each wave)."""
    rows, info, cls = (a.astype(np.int64) for a in (rows, info, cls))
    f, kw = fr_in.shape
    ni = kw - 3
    c_pad = cls.shape[0] if ni else 0
    i_tab = info.shape[1] // 2 if ni else 0
    cap, hsize = layout(f, c_pad)
    cl = np.zeros((W, 8 + ni), np.int64)
    if ni:
        cl[:c_pad] = cls
    fr = fr_in.T.astype(np.int64) & M32
    fr[0] ^= BIAS
    fr[-1] ^= BIAS
    k, peak, ovf, acc = k0, n_alive, False, R == 0
    waves = []
    while not acc and n_alive > 0 and not ovf and k < lim:
        cand = []
        acc_now = False
        for warp in range(32):
            for s in range(warp, f, 32):
                got = expand_state(fr[:, s], rows, info, cl, c_pad, i_tab,
                                   R, ni)
                if got is not None:
                    cand += got[0]
                    acc_now |= got[1]
        assert len(cand) <= cap
        uniq = dedupe(cand, hsize)
        n_new = len(uniq)
        ovf_now = n_new > f and not acc_now
        peak = max(peak, n_new)
        if not ovf_now:
            keys = np.array([cand[x] for x in uniq], np.int64).reshape(-1, kw)
            rk = ranks(keys)
            assert sorted(rk) == list(range(n_new))
            fr = np.zeros((kw, f), np.int64)
            fr[0] = fr[-1] = SENT_D ^ BIAS
            fr[1] = M32
            fr[:, rk[rk < f]] = keys[rk < f].T
            k += 1
            n_alive = min(n_new, f)
        ovf, acc = ovf or ovf_now, acc or acc_now
        waves.append(dict(frontier=unbias(fr), n_new=n_new, acc=acc,
                          ovf=ovf, k=k, peak=peak, n_alive=n_alive))
    res = np.array([acc, ovf, k, peak, n_alive], np.int64)
    return unbias(fr), res, waves


@contextlib.contextmanager
def plain_route():
    """The kernel's route off (its capacity bound 0): the plain loop."""
    keep = wgl.RUNG_KERNEL_F_MAX
    wgl.RUNG_KERNEL_F_MAX = 0
    try:
        yield
    finally:
        wgl.RUNG_KERNEL_F_MAX = keep


def plain_waves(tables, R, f, init, lim):
    """``_wgl_loop`` a wave at a time (``k_stop`` = k + 1), with
    ``_expand``'s n_new for each wave: the state after each wave."""
    k, d, w, i, v, n = init
    I = lim                    # keeps R + I + 1 past lim
    acc = ovf = False
    peak = int(n)
    waves = []
    with plain_route():
        while not acc and int(n) > 0 and not ovf and k < lim:
            n_new = int(wgl._expand(d, w, i, v, tables, R, I, W, f)[4])
            acc1, ovf1, k, pk, (d, w, i, v, n) = wgl._wgl_loop(
                tables, R, I, f, W, (k, d, w, i, v, n), k_stop=k + 1)
            acc, ovf, peak = acc or acc1, ovf or ovf1, max(peak, pk)
            rows = torch.cat([d[:, None], w, i, v[:, None]], 1).numpy()
            waves.append(dict(frontier=rows, n_new=n_new, acc=acc, ovf=ovf,
                              k=k, peak=peak, n_alive=int(n)))
    return waves


@pytest.fixture
def model_card(monkeypatch):
    """The rung kernel's route taken on the CPU, with the model in the
    launch's place: every rung run the kernel would take is answered by
    the model through the real ``_rung_kernel_loop`` and held, wave by
    wave, against the plain loop on the same key's tables; the tables
    the model reads are built by the frame builder's model. Returns the
    held runs' (waves, largest n_new, overflowed)."""
    from test_torch_wgl_frames_model import frames_launch
    fits = wgl._rung_kernel_fits
    loop = wgl._rung_kernel_loop
    runs = []
    last = {}

    def launch(rows, info, cls, fr, n_alive, out, res, R, k0, lim):
        got, r, waves = rung_model(rows.numpy(), info.numpy(), cls.numpy(),
                                   fr.numpy(), int(n_alive[0]), R, k0, lim)
        out.copy_(torch.from_numpy(got))
        res.copy_(torch.from_numpy(r))
        last["waves"] = waves

    def held(tables, R, lim, k0, d, w, i, v, n):
        got = loop(tables, R, lim, k0, d, w, i, v, n)
        want = plain_waves(tables, R, d.shape[0], (k0, d, w, i, v, n), lim)
        assert len(last["waves"]) == len(want)
        for j, (g, p) in enumerate(zip(last["waves"], want)):
            for name in ("n_new", "acc", "ovf", "k", "peak", "n_alive"):
                assert g[name] == p[name], f"wave {j}: {name} differs"
            assert np.array_equal(g["frontier"], p["frontier"]), \
                f"wave {j}: frontier differs"
        runs.append((len(want), max((p["n_new"] for p in want), default=0),
                     got[1]))
        return got

    monkeypatch.setattr(wgl, "_rung_kernel_fits",
                        lambda dev, *a: fits(torch.device("cuda"), *a))
    monkeypatch.setattr(_cuda, "wgl_rung_limits", kernel_limits)
    monkeypatch.setattr(wgl, "_rung_kernel_loop", held)
    monkeypatch.setattr(_cuda, "wgl_frames", frames_launch)
    monkeypatch.setattr(_cuda, "wgl_rung", launch)
    monkeypatch.setattr(wgl, "RUNG_KERNEL_LAUNCHES", 0)
    return runs


def test_route_takes_one_word_windows_up_to_128_on_the_card(monkeypatch):
    """Up to ``RUNG_KERNEL_F_MAX`` and within the limits the kernel
    states (F 128, 32 info classes, 2 count words)."""
    assert kernel_limits() == (128, 32, 2)
    monkeypatch.setattr(_cuda, "wgl_rung_limits", kernel_limits)
    cuda, cpu = torch.device("cuda"), CPU
    fits = wgl._rung_kernel_fits
    assert fits(cuda, 32, 32, 16, 1)
    assert fits(cuda, 128, 32, 16, 1)
    assert fits(cuda, 128, 32, 0, 0)
    assert not fits(cpu, 32, 32, 16, 1)
    assert not fits(cuda, 256, 32, 16, 1)
    assert not fits(cuda, 32, 64, 16, 1)
    assert not fits(cuda, 32, 32, 16, 4)
    assert not fits(cuda, 32, 32, 64, 1)


def test_the_launch_refuses_tensors_off_the_card():
    """``_cuda.wgl_rung`` checks device, type, layout and shape before it
    builds or launches anything."""
    p = wgl.pack_register_history(port(fuzz(32, True, False, seed=3210,
                                            n=1)[0][0]))
    tables = wgl.device_tables(p, CPU)
    ni = wgl.info_dims(p)[1]
    rows, info, cls = wgl._rung_kernel_tables(tables, ni)
    d, w, i, v, n = wgl._initial_frontier(32, 1, ni, CPU)
    fr = torch.cat([d[:, None], w, i, v[:, None]], 1)
    args = [rows, info, cls, fr, n.reshape(1), torch.empty_like(fr),
            torch.empty(5, dtype=torch.int64)]
    with pytest.raises(ValueError, match="wrong device"):
        _cuda.wgl_rung(*args, p.R, 0, p.R + p.I + 1)
    args[0] = rows.to(torch.int64)
    with pytest.raises(ValueError):
        _cuda.wgl_rung(*args, p.R, 0, p.R + p.I + 1)


@pytest.mark.parametrize("seed", [31, 3210])
def test_a_batched_group_builds_each_keys_tables_on_the_card(
        model_card, seed, tmp_path):
    """Three keys of one group on the batched rung at 128: each key's
    tables built once on the card, its rung run held wave by wave, and
    the same dicts as the plain route (the group's stacked host
    tables)."""
    from test_torch_wgl_frames_model import recorded
    rng = random.Random(seed)
    groups = {}
    while True:
        p = wgl.pack_register_history(gen_history(
            rng, n_procs=10, n_ops=60, values=4, info_rate=0.25,
            dur_scale=6.0))
        if p.ok and p.w == 32 and p.I:
            same = groups.setdefault(wgl.group_key(p), [])
            same.append(p)
            if len(same) == 3:
                break
    got, _, cards = recorded(
        lambda: wgl.check_packed_batch(same, device="cpu"), tmp_path)
    with plain_route():
        want, _, want_cards = recorded(
            lambda: wgl.check_packed_batch(same, device="cpu"), tmp_path)
    assert [strip(g) for g in got] == [strip(x) for x in want]
    assert (cards, want_cards) == (3, 0)
    assert len(model_card) == 3


def test_ranks_are_lex_orders():
    """Unsigned order over the biased key words is ``_lex_order``'s over
    (d, mask, counts, v) with d and v signed."""
    rng = np.random.default_rng(3)
    n = 300
    d = rng.choice([-5, 0, 7, 2 ** 31 - 1], n)
    words = rng.choice([0, 1, 2 ** 31, M32], (n, 2))
    v = rng.choice([-1, 0, 3, 2 ** 31 - 1], n)
    rows = np.unique(np.column_stack([d, words, v]), axis=0)
    keys = rows & M32
    keys[:, 0] ^= BIAS
    keys[:, -1] ^= BIAS
    perm = wgl._lex_order([torch.from_numpy(rows[:, 0] + 2 ** 31),
                           torch.from_numpy(rows[:, 1] & M32),
                           torch.from_numpy(rows[:, 2] & M32),
                           torch.from_numpy(rows[:, 3] + 2 ** 31)])
    assert np.array_equal(np.argsort(ranks(keys)), perm.numpy())


@pytest.mark.parametrize("info,corrupt", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_model_matches_every_wave_on_fuzz(model_card, info, corrupt):
    for h, _ in fuzz(32, info, corrupt, seed=3200 + 10 * info + corrupt):
        p = wgl.pack_register_history(port(h))
        got = wgl.check_packed(p, f_max=32, device="cpu")
        with plain_route():
            want = wgl.check_packed(p, f_max=32, device="cpu")
        assert strip(got) == strip(want)
    assert wgl.RUNG_KERNEL_LAUNCHES == len(model_card) > 0
    assert max(n for _, n, _ in model_card) > 1


def _ladder_packs() -> list:
    """The first 28 packs of the ladder test's rung-climbing generator
    (``gen_history`` from ``random.Random(31)``)."""
    rng = random.Random(31)
    return [wgl.pack_register_history(gen_history(
        rng, n_procs=10, n_ops=60, values=4, info_rate=0.25, dur_scale=6.0))
        for _ in range(28)]


def test_model_matches_a_search_that_climbs_the_ladder(model_card):
    """Rungs 32 and 128 overflow in the model, and the plain rungs of
    256 and up resume their frozen frontiers (to 2048, peak 1,680): the
    same dict; and the spill hand-off's frontier bytes past the top."""
    p = _ladder_packs()[20]
    got = wgl.check_packed(p, f_max=32, device="cpu")
    with plain_route():
        want = wgl.check_packed(p, f_max=32, device="cpu")
    assert got == want and got["rungs"] >= 3
    assert [ovf for _, _, ovf in model_card] == [True, True]
    del model_card[:]
    q = wgl.pack_register_history(port(_concurrent_writes_history(16, 1)))
    got = wgl.check_packed(q, f_max=32, spill=False, device="cpu")
    with plain_route():
        want = wgl.check_packed(q, f_max=32, spill=False, device="cpu")
    assert strip(got) == strip(want) and got["overflow"]
    assert got["_resume"][2] == want["_resume"][2]
    assert frontier_bytes(got["_resume"][1]) == \
        frontier_bytes(want["_resume"][1])
    assert [ovf for _, _, ovf in model_card] == [True, True]


def test_model_matches_a_batched_rung_whose_key_climbs_from_512(
        model_card):
    """Two keys of one group share the batched rung at 128: one settles
    there (peak 11), the other overflows it (peak 182) and climbs from
    F_MAX = 512 on the plain rungs."""
    packs = _ladder_packs()
    p, q = packs[27], packs[7]
    assert wgl.group_key(p) == wgl.group_key(q)
    got = wgl.check_packed_batch([p, q], device="cpu")
    with plain_route():
        want = wgl.check_packed_batch([p, q], device="cpu")
    assert [strip(g) for g in got] == [strip(x) for x in want]
    assert "batched" not in got[0] and got[1]["batched"]
    assert [ovf for _, _, ovf in model_card] == [True, False]


@pytest.mark.parametrize("budget", BUDGETS)
def test_model_matches_at_every_pause(model_card, budget):
    for h in _prefix_histories():
        p = wgl.pack_register_history(port(h))
        if p.w != 32:
            continue
        got = want = None
        while True:
            got = wgl.check_prefix(p, got, max_waves=budget, device="cpu")
            with plain_route():
                want = wgl.check_prefix(p, want, max_waves=budget,
                                        device="cpu")
            assert got.done == want.done
            assert (got.k, got.rungs, got.rung_i, got.peak,
                    got.waves_run) == (want.k, want.rungs, want.rung_i,
                                       want.peak, want.waves_run)
            if got.done:
                break
            assert frontier_bytes(got.frontier) == \
                frontier_bytes(want.frontier)
        assert strip(got.result) == strip(want.result)
    assert len(model_card) > 0
