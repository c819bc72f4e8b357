"""A numpy model of ``csrc/wgl_wave.cu``'s wave, warp by warp and lane
by lane, held after EVERY wave against the plain version's own state.

The kernel has no CPU mode, so its design is checked here: one block of
32 warps per key, warp w owning state s(w) = NR*(w % SEGK) + w // SEGK
(the w-th run of wk candidate slots in plane order), lane r of each
working warp holding frontier row r (the model keeps one copy of the
rows). Its steps, as the model writes them:

- per-state facts (version, ceiling prune) computed in the warp;
- the partial dedupe as a comparison of STATES: a valid candidate
  (s, o) equals the valid candidate (s', o) of the same op exactly when
  the two states' mask words are equal and, for a read or a CAS, their
  values are (see ``_model``); the warp ballots that over the rows its
  dedupe set D(s) names, the states s - d and s - NR*gs of the
  reference's row and lane rolls;
- only the warps of filled states expand them (a warp of an empty state
  keeps nothing); warp totals, the count (a sum over all 32 totals in
  every warp) and each warp's base (the totals of the warps before it);
- the exact frontier dedupe as ``__match_any_sync`` over the compacted
  rows: a filled row survives when it is the lowest lane of its match
  group, unfilled rows carrying a key no filled row can have;
- the hand-off: row r is filled iff r < min(count, F), and the warps'
  own states are shuffled out of the surviving rows; row 0 is filled
  iff count > 0, so the death test reads the count, and the waves are
  the waves run.

The state after each wave is read from ``wave_search_reference`` itself
(a trace of its locals, the function unchanged): the frontier rows, the
kept candidates, count, peak, overflow, acceptance and waves must all
be equal, at wk = 32, 64 and 128, on the fuzz of
``test_torch_wgl_mxu.py``, its overflowing searches, a batch of 64
keys, and histories of unversioned concurrent writes: there one mask
carries several values, the only case in which the partial dedupe
kills a candidate (every write of the fuzz asserts its version, so a
mask fixes the value). Tolerance 0.
"""

import inspect
import random
import sys

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.ops import wgl_mxu as ref_mxu
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.testing import (gen_history,
                                           unversioned_rounds_history)

from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_pack import fuzz
from test_torch_wgl_mxu import _port_pack, _tables

F = wgl_mxu.F
M32 = 0xFFFFFFFF
LANE = np.arange(32)


def _popc(x):
    return np.bitwise_count(x.astype(np.uint64)).astype(np.int64)


def warp_states(wk):
    """The state each of the 32 warps owns: the w-th run of wk slots of
    the (NR, 128) plane, idx = p*128 + q, is state NR*(q // wk) + p."""
    _, nr, _, segk, _ = wgl_mxu._dims(wk)
    w = np.arange(32)
    return nr * (w % segk) + w // segk


def dedupe_rows(wk):
    """[warp, row] True where the row's state is in the warp's partial
    dedupe set: s - d for 1 <= d < min(NR, 8) when s % NR >= d (d plane
    rows up), s - NR*gs for 1 <= gs < SEGK when s // NR >= gs (wk*gs
    lanes left)."""
    _, nr, _, segk, _ = wgl_mxu._dims(wk)
    out = np.zeros((32, 32), bool)
    for w, s in enumerate(warp_states(wk)):
        for d in range(1, min(nr, 8)):
            if s % nr >= d:
                out[w, s - d] = True
        for gs in range(1, segk):
            if s // nr >= gs:
                out[w, s - nr * gs] = True
    return out


def _model(tab, scal, wk):
    """The kernel's waves over K keys (one block each). Returns a list,
    one entry per wave run, of the state after it: rows (filled, words,
    value), the kept candidates in plane order, count, peak, overflow,
    acceptance and the waves counted so far; and, per key, the valid
    candidates the partial dedupe killed in the wave (``dups``)."""
    nw, nr, np_, segk, _ = wgl_mxu._dims(wk)
    tab = tab.astype(np.int64)
    scal = scal.astype(np.int64)
    K, r_pad, _ = tab.shape
    sw = warp_states(wk)
    dset = dedupe_rows(wk)
    R = scal[:, 0, wgl_mxu.S_R]
    # lane r of every warp holds frontier row r
    rfill = np.zeros((K, 32), bool)
    rfill[:, 0] = True
    rw = np.zeros((K, 32, nw), np.int64)
    rv = np.zeros((K, 32), np.int64)
    rv[:, 0] = 1
    count = np.ones(K, np.int64)     # the initial frontier: row 0
    waves = np.zeros(K, np.int64)
    acc = np.zeros(K, bool)
    ovf = np.zeros(K, bool)
    peak = np.ones(K, np.int64)
    trace = []
    for kk in range(r_pad):
        # the death test: row 0 is filled iff the last wave kept one
        if not count.any():
            break
        waves += count > 0
        row = tab[:, kk][:, None, :]                      # [K, 1, TL]
        sr = scal[:, kk]
        # the warp's own state, shuffled out of lane s(w)
        mf, mw, mv = rfill[:, sw], rw[:, sw], rv[:, sw]   # [K, W(, nw)]
        ver = sum(_popc(mw[..., wi] & (sr[:, None, wgl_mxu.S_UPD0 + wi]
                                       & M32)) for wi in range(nw))
        st_ok = mf & (ver <= sr[:, None, wgl_mxu.S_CEILB])
        sh = sr[:, wgl_mxu.S_SHIFT]
        lm = np.stack([np.where(np.clip(sh - 32 * wi, 0, 32) >= 32, M32,
                                (1 << np.clip(sh - 32 * wi, 0, 31)) - 1)
                       for wi in range(nw)], -1)          # [K, nw]
        missing = lm[:, None, :] & ~mw & M32              # [K, W, nw]
        segbad = np.zeros((K, 32), bool)
        valid, val, isw, nwords = [], [], [], []
        for j in range(nw):
            o = j * 32 + LANE                             # lanes take ops
            av, vc = row[..., o], row[..., wk + o]
            a1, a2 = av & 0xFFFF, (av >> 16) & 0xFFFF
            rver = ((vc & 0xFFFF) ^ 0x8000) - 0x8000
            rceil = (((vc >> 16) & 0xFFFF) ^ 0x8000) - 0x8000
            fsk = row[..., wk * (2 + nw) + o] & 0xFFFF
            bit = np.int64(1) << LANE
            not_set = (mw[..., j, None] & bit) == 0       # [K, W, L]
            segbad |= (not_set & (rceil < ver[..., None])).any(-1)
            preds_in = np.ones_like(not_set)
            slide_ok = np.ones_like(not_set)
            for wi in range(nw):
                pm = row[..., wk * (2 + wi) + o] & M32
                preds_in &= (mw[..., wi, None] & pm) == pm
                own = bit if wi == j else 0
                slide_ok &= (missing[..., wi, None] & ~own) == 0
            is_read, is_write = fsk == 1, fsk == 2
            is_cas = fsk == 3
            v = ver[..., None]
            ver_ok = (rver == -32768) | (is_read & (rver == v)) | \
                ((is_write | is_cas) & (rver == v + 1))
            sv = mv[..., None]
            model_ok = (is_read & ((a1 == 0) | (a1 == sv))) | is_write | \
                (is_cas & (a1 == sv))
            valid.append((fsk > 0) & not_set & preds_in & ver_ok
                         & model_ok & slide_ok)
            val.append(np.where(is_read, sv, np.where(is_write, a1, a2)))
            isw.append(np.broadcast_to(is_write, not_set.shape))
            # the successor's words: (state | bit o) >> sh, word by word
            nwf = [np.broadcast_to(mw[..., wi, None] | (bit if wi == j else 0),
                                   not_set.shape) for wi in range(nw)]
            k_off, r_off = (sh >> 5)[:, None, None], (sh & 31)[:, None, None]
            words = []
            for i in range(nw):
                lo_w = np.zeros_like(nwf[0])
                hi_w = np.zeros_like(nwf[0])
                for ko in range(nw + 1):
                    if i + ko < nw:
                        lo_w = np.where(k_off == ko, nwf[i + ko], lo_w)
                    if i + ko + 1 < nw:
                        hi_w = np.where(k_off == ko, nwf[i + ko + 1], hi_w)
                carry = np.where(r_off == 0, 0,
                                 (hi_w << (32 - r_off)) & M32)
                words.append((lo_w >> r_off) | carry)
            nwords.append(np.stack(words, -1))
        alive = st_ok & ~segbad
        # partial dedupe: for two valid candidates of one op, equal
        # successors <=> equal state words (the slide keeps the low bits
        # set) and, for a read or a CAS, equal state values (a write's
        # value is its own). Lane r compares row r with the warp's state.
        eqw = rfill[:, None, :] & dset[None] & np.all(
            rw[:, None, :, :] == mw[:, :, None, :], -1)  # [K, W, L]
        eqv = eqw & (rv[:, None, :] == mv[:, :, None])
        dw, dv = eqw.any(-1)[..., None], eqv.any(-1)[..., None]
        keep = [alive[..., None] & valid[j] & ~np.where(isw[j], dw, dv)
                for j in range(nw)]
        dups = sum((alive[..., None] & valid[j] & np.where(isw[j], dw, dv))
                   .sum((1, 2)) for j in range(nw))
        # warp totals; every warp sums all 32 (lane i reads total i) and
        # the totals of the warps before it
        tot = sum(kj.sum(-1) for kj in keep)              # [K, W]
        count = tot.sum(1)
        base = np.cumsum(tot, 1) - tot
        peak = np.maximum(peak, count)
        ovf |= count > F
        acc |= (kk == R - 1) & (count > 0)
        # compaction: rank = warp base + earlier ballots + lower lanes
        fw = np.zeros((K, F, nw), np.int64)
        fv = np.zeros((K, F), np.int64)
        pre = np.zeros((K, 32, 1), np.int64)
        for j in range(nw):
            kj = keep[j]
            rank = base[..., None] + pre + np.cumsum(kj, -1) - kj
            pre = pre + kj.sum(-1, keepdims=True)
            ki, wi_, li = np.nonzero(kj & (rank < F))
            fw[ki, rank[ki, wi_, li]] = nwords[j][ki, wi_, li]
            fv[ki, rank[ki, wi_, li]] = val[j][ki, wi_, li] & 0xFFFF
        # hand-off: row r is filled iff r < min(count, F); the exact
        # dedupe is __match_any_sync over (words, value) keys, unfilled
        # rows keyed with a value no filled row has (>= 0x10000)
        filled = LANE[None, :] < np.minimum(count, F)[:, None]
        kw = np.where(filled[..., None], fw, 0)
        kv = np.where(filled, fv, 0x10000)
        same = np.all(kw[:, :, None, :] == kw[:, None, :, :], -1) & \
            (kv[:, :, None] == kv[:, None, :])            # [K, L, L']
        lowest = ~(same & (LANE[None, :] < LANE[:, None])[None]).any(-1)
        rfill = filled & lowest
        rw = np.where(rfill[..., None], kw, 0)
        rv = np.where(rfill, kv, 0)
        # kept candidates in plane order: slot w*wk + o
        kept = np.stack(keep, -2).reshape(K, np_)
        trace.append(dict(filled=rfill.copy(), words=rw.copy(),
                          value=rv.copy(), kept=kept, count=count,
                          peak=peak.copy(), ovf=ovf.copy(), acc=acc.copy(),
                          waves=waves.copy(), dups=dups))
    return trace


def _reference_trace(tab, scal, wk):
    """``wave_search_reference`` run unchanged, its locals read after
    every wave through a line tracer: the frontier rows from the plane
    slots of each state, the kept candidates (``valid`` after the partial
    dedupe), count, and the folded peak, overflow, acceptance and waves.
    Returns (the function's output, per-wave states)."""
    fn = wgl_mxu.wave_search_reference
    code = fn.__code__
    lines, first = inspect.getsourcelines(fn)
    row_line = first + next(i for i, t in enumerate(lines)
                            if "row = tab64[:, kk, :]" in t)
    nw, nr, np_, _, _ = wgl_mxu._dims(wk)
    r = np.arange(F)
    p, q = r % nr, (r // nr) * wk
    states = {}
    ran = []

    def grab(loc, wave):
        alive = loc["alive_p"].numpy()
        states[wave] = dict(
            filled=alive[:, p, q] != 0,
            words=np.stack([w.numpy()[:, p, q] for w in loc["stw"]], -1),
            value=loc["stv"].numpy()[:, p, q],
            kept=loc["valid"].reshape(-1, np_).numpy(),
            count=loc["valid"].reshape(-1, np_).sum(1).numpy(),
            **{k: loc[n].reshape(-1, np_).to(torch.int64).amax(1).numpy()
               for k, n in (("peak", "peak_p"), ("ovf", "ovf_p"),
                            ("acc", "acc_p"), ("waves", "wav_p"))})

    def local(frame, event, arg):
        if event == "line" and frame.f_lineno == row_line:
            kk = frame.f_locals["kk"]
            if kk > 0:
                grab(frame.f_locals, kk - 1)
            ran.append(kk)
        elif event == "return" and ran and ran[-1] not in states:
            grab(frame.f_locals, ran[-1])
        return local

    def outer(frame, event, arg):
        return local if frame.f_code is code else None

    old = sys.gettrace()
    sys.settrace(outer)
    try:
        out = fn(torch.from_numpy(tab), torch.from_numpy(scal), wk)
    finally:
        sys.settrace(old)
    return out.numpy(), [states[w] for w in sorted(states)]


def _hold(tab, scal, wk):
    """The model against the reference after every wave; returns the
    largest count of a wave and the candidates the partial dedupe killed
    in all (what the inputs exercised)."""
    tab, scal = tab.numpy(), scal.numpy()
    out, ref = _reference_trace(tab, scal, wk)
    got = _model(tab, scal, wk)
    # the model stops at the first wave with no live frontier in any
    # key; the reference checks every DONE_EVERY waves and runs dead
    # waves that change nothing
    assert len(got) <= len(ref)
    for kk, (g, r) in enumerate(zip(got, ref)):
        for name in ("filled", "words", "value", "kept", "count", "peak",
                     "ovf", "acc", "waves"):
            assert np.array_equal(np.asarray(g[name], np.int64),
                                  np.asarray(r[name], np.int64)), \
                f"wave {kk}: {name} differs"
    for r in ref[len(got):]:
        assert not r["filled"].any() and not r["count"].any()
    last = got[-1]
    vec = np.stack([last["acc"], last["ovf"], last["peak"], last["waves"]],
                   1).astype(np.int32)
    assert np.array_equal(vec, out)
    return (max(int(g["count"].max()) for g in got),
            sum(int(g["dups"].sum()) for g in got))


def _batch(packs, wk):
    r_pad = max(max(wgl.bucket(p.R), wgl_mxu.TSUB) for p in packs)
    return _tables(packs, r_pad, wk)


@pytest.mark.parametrize("wk", [32, 64, 128])
def test_warp_owns_one_state_in_plane_order(wk):
    """Warp w's run of wk slots, idx = w*wk + o, is state s(w) for every
    op, and the 32 warps cover the 32 states once."""
    _, nr, _, _, _ = wgl_mxu._dims(wk)
    idx = np.arange(32)[:, None] * wk + np.arange(wk)[None, :]
    p, q = idx // 128, idx % 128
    assert np.array_equal(nr * (q // wk) + p,
                          np.broadcast_to(warp_states(wk)[:, None],
                                          idx.shape))
    assert sorted(warp_states(wk)) == list(range(32))
    # the dedupe set is the reference's: slot idx - d*128 and idx - wk*gs
    want = np.zeros((32, 32), bool)
    segk = 128 // wk
    for w in range(32):
        for d in range(1, min(nr, 8)):
            if p[w, 0] >= d:
                want[w, warp_states(wk)[w - d * segk]] = True
        for gs in range(1, segk):
            if q[w, 0] >= wk * gs:
                want[w, warp_states(wk)[w - gs]] = True
    assert np.array_equal(dedupe_rows(wk), want)


@pytest.mark.parametrize("wk", [32, 64, 128])
@pytest.mark.parametrize("corrupt", [False, True])
def test_model_matches_every_wave(wk, corrupt):
    packs = [_port_pack(h) for h, _ in fuzz(
        wk, corrupt, 0.0, seed=500 + wk + corrupt, n=4, need_supported=True)]
    assert _hold(*_batch(packs, wk), wk)[0] > 1


def test_model_matches_on_overflowing_searches():
    """``test_overflowing_searches_match``'s inputs: truncation at F
    and which candidates survive it follow the ranks."""
    rng = random.Random(77)
    from test_wgl import gen_history as ref_gen_history
    seen_ovf = 0
    for trial in range(40):
        h = ref_gen_history(rng, n_procs=14, n_ops=rng.randint(50, 80),
                            dur_scale=20.0, corrupt=trial % 3 == 0)
        rp = ref_wgl.pack_register_history(h)
        if not ref_mxu.supported(rp):
            continue
        seen_ovf += int(_hold(*_batch([_port_pack(h)], rp.w), rp.w)[0] > F)
        if seen_ovf >= 3:
            break
    assert seen_ovf >= 3, "fuzz produced too few overflowing searches"


def test_model_matches_on_a_batch_of_64_keys():
    """64 keys of 200 ops in one batch (every third corrupted), as the
    batched launch runs them: keys die at different waves."""
    rng = random.Random(7)
    packs = []
    while len(packs) < 64:
        p = wgl.pack_register_history(gen_history(
            rng, n_procs=4, n_ops=200, corrupt=len(packs) % 3 == 0))
        if wgl_mxu.supported(p) and p.w == 32:
            packs.append(p)
    assert _hold(*_batch(packs, 32), 32)[0] > 1


@pytest.mark.parametrize("wk,wide", [(32, 0), (64, 40), (128, 90)])
def test_model_matches_on_unversioned_writes(wk, wide):
    """Twelve histories of small rounds (1-4 ops), with one round of
    ``wide`` concurrent ops in the middle to widen the window: states
    with equal masks and different values meet, and a write from each
    gives one successor, which the partial dedupe keeps once."""
    rng = random.Random(11)
    packs = []
    for _ in range(12):
        sizes = [rng.randint(1, 4) for _ in range(rng.randint(4, 8))]
        if wide:
            sizes.insert(len(sizes) // 2, wide)
        p = wgl.pack_register_history(unversioned_rounds_history(rng, sizes))
        assert wgl_mxu.supported(p) and p.w == wk
        packs.append(p)
    assert _hold(*_batch(packs, wk), wk)[1] > 0
