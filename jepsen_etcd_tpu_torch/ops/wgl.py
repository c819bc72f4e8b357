"""Linearizability search for versioned-register histories: the host
packer, the capacity ladder and the device dispatch (the port of the
reference's ``ops/wgl.py``).

The key insight making the search device-shaped: in a history with
bounded concurrency, sort the must-linearize (:ok) ops by invocation;
then any reachable "linearized set" consists of a *forced prefix* plus
a bitmask over a sliding window of at most W undecided ops (W
auto-selects 32, 64, or 128 — one, two, or four uint32 words — per
history). ``pack_register_history`` builds the per-op vectors and the
window geometry (``Packed``); ``ensure_frames`` materializes the
per-depth [R, W] frame tables.

Engines, in the order ``check_packed`` tries them: the wave kernel
(ops/wgl_mxu.py, frontier 32, no info ops); the capacity ladder
(``_expand`` / ``_wgl_loop`` as PyTorch ops on the device, rungs 32 ->
4096, each rung resuming the frozen frontier of the last); past the top
rung the host-driven spill BFS (``_spill_bfs``), which is complete.
``check_prefix`` is the ladder paused every few waves (the streaming
API).

Frontier rows carry uint32 mask and count words in int64 tensors, so
their unsigned order survives; every shift masks back to 32 bits.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..checkers.linearizable import history_entries
from ..device import resolve_device
from .common import UnsupportedValue, ValueIds, as_version, \
    register_value_sets

W = 32          # single-word window width (fast path)
W_MAX = 128     # widest window the kernel packs (4 uint32 words)
NI_MAX = 4      # count words per state (bit budget for info class fields)
I_TABLE_MAX = 256  # member-table width cap ([R, I, NW] memory)
F_MAX = 512     # frontier capacity per wave (middle of the ladder)
F_MAX_BIG = 4096  # top of the ladder; past it the spill BFS takes over
#: frontier capacities the ladder climbs; a search settles at the
#: smallest rung that holds its peak frontier (copied from the reference)
LADDER = [32, 128, 256, F_MAX, 1024, 2048, F_MAX_BIG]
SENTINEL_D = 2 ** 31 - 1        # int32 max: "no state" depth
SENTINEL_W = 0xFFFFFFFF         # uint32 max: "no state" mask word
SENTINEL_V = 2 ** 31 - 1        # int32 max: "no state" value

READ, WRITE, CAS = 0, 1, 2
NO_ASSERT = -(2 ** 30)  # distinct from any real (possibly corrupted) version
NONE_VAL = 0     # value id for "key unset"
WILDCARD = -1    # read asserted nothing

# spill-mode limits (copied from the reference): chunk size per expand
# call, frontier cap (past it BFS cannot win; the DFS oracle takes the
# history), and total-state budget; histories with many info ops get a
# smaller budget so hopeless cases exit in seconds
SPILL_CHUNK = 4096
SPILL_FRONTIER_LIMIT = 400_000
SPILL_STATE_BUDGET = 3_000_000
SPILL_I_LIMIT = 24
SPILL_STATE_BUDGET_HIGH_I = 1_000_000
SPILL_WALL_BUDGET_S = 60.0  # hopeless-width searches must fail fast

#: waves between host reads of the ladder's loop condition. Waves past
#: the end are masked no-ops, so any value gives the same result.
SYNC_EVERY = 8
#: on the card, a rung with at least GRAPH_MIN_WAVES waves to go runs
#: them GRAPH_WAVES at a time from a captured CUDA graph: the eager loop
#: issues about 220 small operations a wave and waits on their launches
GRAPH_MIN_WAVES = 256
GRAPH_WAVES = 32

_M32 = 0xFFFFFFFF


def pack_bits(bits: np.ndarray, nw: int) -> np.ndarray:
    """Pack a trailing bool axis of width w = 32*nw into nw
    little-endian uint32 words (new trailing axis replaces it)."""
    w = bits.shape[-1]
    assert w <= 32 * nw
    if w < 32 * nw:
        padded = np.zeros(bits.shape[:-1] + (32 * nw,), dtype=bool)
        padded[..., :w] = bits
        bits = padded
    by = np.packbits(np.ascontiguousarray(bits), axis=-1,
                     bitorder="little")
    return by.view(np.uint32).reshape(bits.shape[:-1] + (nw,)) \
        if by.dtype.byteorder in "|=" and np.little_endian \
        else (by.astype(np.uint32).reshape(bits.shape[:-1] + (nw, 4))
              * (np.uint32(1) << (8 * np.arange(4, dtype=np.uint32)))
              ).sum(-1, dtype=np.uint32)


@dataclass
class Packed:
    """Host-packed tables for one key's history (field for field the
    reference's ``Packed``)."""

    ok: bool
    reason: str = ""
    blowup: bool = False  # structurally past kernel capacity
    R: int = 0
    I: int = 0
    n_values: int = 0
    w: int = W      # window width (32 / 64 / 128 = 1, 2, 4 words)
    # required frame tables ([R, W] unless noted; NW = w // 32
    # little-endian uint32 mask words on the trailing axis) — lazy,
    # materialized by ensure_frames
    shift: Any = None         # [R] int32
    static_ok: Any = None     # [R, W] bool
    f_code: Any = None        # [R, W] int8
    a1: Any = None            # [R, W] int32 (read: rval / write: wval / cas: old)
    a2: Any = None            # [R, W] int32 (cas: new)
    ver: Any = None           # [R, W] int32 (version assertion or NO_ASSERT)
    pred_frame: Any = None    # [R, W, NW] uint32
    upd_mask: Any = None      # [R, NW] uint32
    u_forced: Any = None      # [R] int32
    ceil_frame: Any = None    # [R, W] int32 (version ceiling / CEIL_INF)
    ceil_beyond: Any = None   # [R] int32 (min ceiling past the window)
    # info tables: crashed updates grouped into symmetry classes whose
    # fired-prefix counts pack into NI uint32 words
    C: int = 0                # number of info symmetry classes
    ni: int = 0               # count words per state
    c_f: Any = None           # [C] int8 (WRITE or CAS)
    c_a1: Any = None          # [C] int32 (write val / cas old)
    c_a2: Any = None          # [C] int32 (cas new)
    c_size: Any = None        # [C] int32 (members per class)
    c_off: Any = None         # [C] int32 (first member index, class-major)
    c_word: Any = None        # [C] int32 (count word index)
    c_shift: Any = None       # [C] int32 (bit offset within the word)
    c_mask: Any = None        # [C] uint32 (count field mask)
    i_static_ok: Any = None   # [R, I] bool, class-major member order
    ipred_frame: Any = None   # [R, I, NW] uint32, class-major member order
    # per-op vectors (the compact source the frames are gathered from;
    # the device frame builder ships these)
    op_a1: Any = None         # [R] int32 (raw, WILDCARD = -1)
    op_a2: Any = None         # [R] int32
    op_ver: Any = None        # [R] int32 (NO_ASSERT sentinel)
    op_f: Any = None          # [R] int8
    op_pred_rank: Any = None  # [R] int32 (# required preds by ret<inv)
    op_ceiling: Any = None    # [R] int32 (version ceiling, INF 2**30)
    inv_rank: Any = None      # [R] int32 (invoke-time rank)
    ret_rank: Any = None      # [R] int32 (return-time rank)
    lo: Any = None            # [R+1] int64 (window base per depth)
    _i_inv_rank: Any = None   # [I] int64 (info invokes on the rank scale)

    @classmethod
    def from_numpy(cls, fields: dict) -> "Packed":
        """A Packed from a dict of numpy arrays and scalars keyed by
        field name (e.g. another packer's ``vars(packed)``); unknown
        keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names})


MUTEX_LOCKED = "locked"


def mutex_adapter(f: str, value):
    """Express mutex ops as CAS register ops: a mutex IS a two-value CAS
    register (acquire = cas(None->locked), release = cas(locked->None),
    no version assertions)."""
    if f == "acquire":
        return "cas", [None, (None, MUTEX_LOCKED)]
    if f == "release":
        return "cas", [None, (MUTEX_LOCKED, None)]
    return None


def pack_mutex_history(history) -> Packed:
    """Pack a mutex (acquire/release) history for the kernel."""
    return pack_register_history(history, adapter=mutex_adapter)


def pack_register_history(history, adapter=None) -> Packed:
    """Build the per-op vectors and window geometry for the kernel.
    Returns ok=False with a reason when the history needs the CPU path.
    ``adapter`` (optional) maps each entry's (f, value) into
    register-language (f, value)."""
    try:
        return _pack_register_history(history, adapter=adapter)
    except UnsupportedValue as e:
        # a value/version whose == semantics the dense id encoding can't
        # carry: sound fallback to the Python oracle
        return Packed(ok=False, reason=f"unsupported value: {e}")


def _pack_register_history(history, adapter) -> Packed:
    entries = history_entries(history)
    if adapter is not None:
        adapted = {}
        for e in entries:
            m = adapter(e.f, e.value)
            if m is None:
                return Packed(ok=False,
                              reason=f"op f={e.f!r} not supported by adapter")
            adapted[e.i] = m

        def fv(e):
            return adapted[e.i]
    else:
        def fv(e):
            return e.f, e.value
    req = sorted([e for e in entries if e.required], key=lambda e: e.invoke)
    R = len(req)
    if R == 0:
        # with no required ops every history linearizes trivially
        return Packed(ok=True, R=0)

    # value id mapping: 0 = None (unset); concrete values from 1, with
    # id-equality iff Python == (ops/common.ValueIds)
    vids = ValueIds()
    val_id = vids.id

    inv = np.array([e.invoke for e in req], dtype=np.int64)
    ret = np.array([e.ret for e in req], dtype=np.int64)
    f_l = [0] * R
    a1_l = [0] * R
    a2_l = [0] * R
    ver_l = [NO_ASSERT] * R
    for i, e in enumerate(req):
        ef, ev = fv(e)
        if ef == "read":
            rv, rval = ev if ev is not None else (None, None)
            if rv is not None:
                ver_l[i] = as_version(rv)
            # A None read value asserts nothing (VersionedRegister.step
            # treats nil op-value as unchecked REGARDLESS of version)
            a1_l[i] = WILDCARD if rval is None else val_id(rval)
        elif ef == "write":
            f_l[i] = WRITE
            wv, wval = ev
            if wv is not None:
                ver_l[i] = as_version(wv)
            a1_l[i] = val_id(wval)
        elif ef == "cas":
            f_l[i] = CAS
            cv, (old, new) = ev
            if cv is not None:
                ver_l[i] = as_version(cv)
            a1_l[i] = val_id(old)
            a2_l[i] = val_id(new)
        else:
            return Packed(ok=False, reason=f"op f={ef!r} not supported")
    f = np.array(f_l, dtype=np.int8)
    a1 = np.array(a1_l, dtype=np.int32)
    a2 = np.array(a2_l, dtype=np.int32)
    ver = np.array(ver_l, dtype=np.int32)

    # --- info (indefinite) ops: may linearize any time after their
    # required predecessors, or never. Reads are droppable; so are ops
    # whose invoke follows every required return.
    sorted_ret = np.sort(ret)
    infos = []
    for e in entries:
        if e.required or fv(e)[0] == "read":
            continue
        npred = int(np.searchsorted(sorted_ret, e.invoke, side="left"))
        if npred >= R:
            continue
        infos.append((e, npred))
    I = len(infos)
    i_f = np.zeros(I, dtype=np.int8)
    i_a1 = np.zeros(I, dtype=np.int32)
    i_a2 = np.zeros(I, dtype=np.int32)
    i_inv = np.zeros(I, dtype=np.int64)
    i_npred = np.zeros(I, dtype=np.int64)
    for j, (e, npred) in enumerate(infos):
        i_inv[j] = e.invoke
        i_npred[j] = npred
        ef, ev = fv(e)
        val = ev if ev is not None else (None, None)
        if val[0] is not None:
            # the kernel's info tables carry no version assertion
            return Packed(ok=False,
                          reason="info op with version assertion")
        if ef == "write":
            i_f[j] = WRITE
            i_a1[j] = val_id(val[1])
        elif ef == "cas" and isinstance(val[1], (list, tuple)) \
                and len(val[1]) == 2:
            i_f[j] = CAS
            old, new = val[1]
            i_a1[j] = val_id(old)
            i_a2[j] = val_id(new)
        else:
            return Packed(ok=False, reason=f"info op f={ef!r} not supported")

    # --- value-space reductions (ops/common.register_value_sets):
    # merge dead values (producible, never asserted) into one id, and
    # drop info cas ops whose old value has no producer.
    triples = list(zip(f.tolist(), a1.tolist(), a2.tolist())) + \
        list(zip(i_f.tolist(), i_a1.tolist(), i_a2.tolist()))
    asserted, producible = register_value_sets(triples)
    dead = producible - asserted - {NONE_VAL}
    if len(dead) > 1:
        dead_id = min(dead)
        for i in range(R):
            if f[i] == WRITE and a1[i] in dead:
                a1[i] = dead_id
            elif f[i] == CAS and a2[i] in dead:
                a2[i] = dead_id
        for j in range(I):
            if i_f[j] == WRITE and i_a1[j] in dead:
                i_a1[j] = dead_id
            elif i_f[j] == CAS and i_a2[j] in dead:
                i_a2[j] = dead_id
    keep = [j for j in range(I)
            if not (i_f[j] == CAS and i_a1[j] != NONE_VAL
                    and int(i_a1[j]) not in producible)]
    if len(keep) < I:
        i_f, i_a1, i_a2 = i_f[keep], i_a1[keep], i_a2[keep]
        i_inv, i_npred = i_inv[keep], i_npred[keep]
        I = len(keep)
    # symmetry classes: info ops with identical (f, a1, a2) are
    # interchangeable and fire in canonical (npred, invoke) order, so
    # the reachable info states are per-class prefix COUNTS packed into
    # fixed bit fields (never straddling a word)
    order = sorted(range(I), key=lambda j: ((int(i_f[j]), int(i_a1[j]),
                                             int(i_a2[j])),
                                            (int(i_npred[j]),
                                             int(i_inv[j]), j)))
    i_f, i_a1, i_a2 = i_f[order], i_a1[order], i_a2[order]
    i_inv, i_npred = i_inv[order], i_npred[order]
    class_runs: list = []  # (key, start, size)
    for j in range(I):
        key_j = (int(i_f[j]), int(i_a1[j]), int(i_a2[j]))
        if class_runs and class_runs[-1][0] == key_j:
            class_runs[-1][2] += 1
        else:
            class_runs.append([key_j, j, 1])
    C = len(class_runs)
    c_f = np.array([k[0] for k, _, _ in class_runs], dtype=np.int8)
    c_a1 = np.array([k[1] for k, _, _ in class_runs], dtype=np.int32)
    c_a2 = np.array([k[2] for k, _, _ in class_runs], dtype=np.int32)
    c_off = np.array([off for _, off, _ in class_runs], dtype=np.int32)
    c_size = np.array([sz for _, _, sz in class_runs], dtype=np.int32)
    c_word = np.zeros(C, dtype=np.int32)
    c_shift = np.zeros(C, dtype=np.int32)
    c_mask = np.zeros(C, dtype=np.uint32)
    word, used = 0, 0
    for ci in range(C):
        bits = max(1, int(c_size[ci]).bit_length())
        if used + bits > 32:
            word, used = word + 1, 0
        c_word[ci] = word
        c_shift[ci] = used
        c_mask[ci] = (1 << bits) - 1
        used += bits
    ni = (word + 1) if C else 0
    if ni > NI_MAX:
        return Packed(ok=False, blowup=True,
                      reason=f"{I} info updates in {C} classes need "
                             f"{ni} count words > {NI_MAX}")
    if I > I_TABLE_MAX:
        return Packed(ok=False, blowup=True,
                      reason=f"{I} info updates > member-table cap "
                             f"{I_TABLE_MAX}")

    pred = np.searchsorted(sorted_ret, inv, side="left")  # ret[j] < inv[i]
    cap = np.searchsorted(inv, ret, side="left") - 1      # inv[j] < ret[i], j != i

    # lo[d] = first rank that can still be absent from a depth-d prefix
    # = the insertion point of d in the running prefix max of cap
    lo = np.searchsorted(np.maximum.accumulate(cap), np.arange(R + 1),
                         side="left").astype(np.int64)
    # feasibility: the window must hold all set bits and all enabled
    # candidates
    width_bits = np.max(np.arange(R + 1) - lo)
    first_lo = lo[np.minimum(pred, R)]
    width_cand = np.max(np.arange(R) - first_lo) + 1
    width = max(width_bits, width_cand)
    if width > W_MAX:
        return Packed(ok=False,
                      reason=f"window {width} > {W_MAX} "
                             f"(concurrency too high for kernel)")
    w = next(c for c in (W, 64, W_MAX) if width <= c)

    is_upd = (f == WRITE) | (f == CAS)
    cum_upd = np.concatenate([[0], np.cumsum(is_upd)])
    u_forced = cum_upd[lo[:R]].astype(np.int32)

    # version ceilings: op e with a version assertion can only fire
    # while the register version is <= its ceiling (read: ver, update:
    # ver-1); version never decreases, so a state whose version exceeds
    # the min ceiling among unlinearized required ops is dead
    CEIL_INF = np.int32(2 ** 30)
    ceiling = np.where(ver == NO_ASSERT, CEIL_INF,
                       np.where(f == READ, ver, ver - 1)).astype(np.int32)
    suffix_min = np.full(R + 1, CEIL_INF, dtype=np.int32)
    suffix_min[:R] = np.minimum.accumulate(ceiling[::-1])[::-1]
    ceil_beyond = suffix_min[np.minimum(lo[:R] + w, R)]       # [R]

    # rank-compress the invoke/return times jointly: pairwise
    # comparisons are order-preserved, and ranks fit int32
    all_times = np.concatenate([inv, ret])
    order = np.argsort(all_times, kind="stable")
    ranks = np.empty(2 * R, dtype=np.int32)
    ranks[order] = np.arange(2 * R, dtype=np.int32)

    p = Packed(
        ok=True, R=R, I=I, n_values=len(vids.rev), w=w,
        shift=(lo[1:] - lo[:-1]).astype(np.int32),
        u_forced=u_forced, ceil_beyond=ceil_beyond,
        C=C, ni=ni, c_f=c_f, c_a1=c_a1, c_a2=c_a2, c_size=c_size,
        c_off=c_off, c_word=c_word, c_shift=c_shift, c_mask=c_mask,
        op_a1=a1, op_a2=a2, op_ver=ver, op_f=f,
        op_pred_rank=pred.astype(np.int32), op_ceiling=ceiling,
        inv_rank=ranks[:R], ret_rank=ranks[R:], lo=lo,
    )
    p._i_inv_rank = (np.searchsorted(
        np.sort(all_times), i_inv, side="left").astype(np.int64)
        if I else np.zeros(0, dtype=np.int64))
    return p


def ensure_frames(p: Packed) -> None:
    """Materialize the [R, W] / [R, W, W] / [R, I] frame tables on the
    Packed (idempotent). The host reference packer
    ``wgl_mxu.pack_tables`` reads them."""
    if p.static_ok is not None or not p.ok or p.R == 0:
        return
    R, w, I = p.R, p.w, p.I
    nw = w // 32
    lo = p.lo
    pred = p.op_pred_rank.astype(np.int64)
    inv = p.inv_rank.astype(np.int64)
    ret = p.ret_rank.astype(np.int64)
    f = p.op_f
    d_idx = np.arange(R)[:, None]                       # [R, 1]
    b_idx = np.arange(w)[None, :]                       # [1, W]
    idx = np.minimum(lo[:R][:, None] + b_idx, R - 1)    # [R, W] clamped
    in_range = (lo[:R][:, None] + b_idx) < R
    p.static_ok = in_range & (pred[idx] <= d_idx)

    # predecessor bits within the frame: bit c <-> rank lo[d]+c, packed
    # into nw little-endian uint32 words (trailing axis)
    ret_frame = ret[idx]                                      # [R, W]
    inv_cand = inv[idx]                                       # [R, W]
    is_pred = (ret_frame[:, None, :] < inv_cand[:, :, None])  # [R, W, W]
    in_range_c = in_range[:, None, :]                         # [R, 1, W]
    p.pred_frame = pack_bits(is_pred & in_range_c, nw)

    is_upd = (f == WRITE) | (f == CAS)
    p.upd_mask = pack_bits(is_upd[idx] & in_range, nw)

    CEIL_INF = np.int32(2 ** 30)
    p.ceil_frame = np.where(in_range, p.op_ceiling[idx], CEIL_INF)
    p.f_code = f[idx].astype(np.int8)
    p.a1 = p.op_a1[idx]
    p.a2 = p.op_a2[idx]
    p.ver = p.op_ver[idx]

    # info predecessor tables: info j enabled at depth d iff every
    # required op with ret < inv_j is linearized
    if I:
        i_inv = p._i_inv_rank
        pred_in_win = in_range[:, :, None] & \
            (ret_frame[:, :, None] < i_inv[None, None, :])    # [R, W, I]
        p.ipred_frame = pack_bits(
            np.swapaxes(pred_in_win, 1, 2), nw)               # [R, I, NW]
        pf = (ret[:, None] < i_inv[None, :])                  # [R, I]
        cum_pf = np.concatenate([np.zeros((1, I), dtype=np.int64),
                                 np.cumsum(pf, axis=0)])      # [R+1, I]
        hi = np.minimum(lo[:R] + w, R)                        # [R]
        p.i_static_ok = cum_pf[hi] == cum_pf[R][None, :]      # [R, I]
    else:
        p.ipred_frame = np.zeros((R, 0, nw), dtype=np.uint32)
        p.i_static_ok = np.zeros((R, 0), dtype=bool)


def bucket(n: int) -> int:
    """Pad R to a power-of-two bucket (at least 16)."""
    b = 16
    while b < n:
        b *= 2
    return b


def info_dims(p: Packed) -> tuple[int, int, int]:
    """Bucketed (c_pad, ni_pad, i_tab): padded class count, count words,
    and member-table width. All zero for info-free histories."""
    if p.C == 0:
        return 0, 0, 0
    c_pad = 8
    while c_pad < p.C:
        c_pad *= 2
    ni_pad = 1
    while ni_pad < p.ni:
        ni_pad *= 2
    i_tab = 8
    while i_tab < p.I:
        i_tab *= 2
    return c_pad, ni_pad, i_tab


def pad_tables(p: Packed, r_pad: int, info: tuple = None) -> dict:
    """The per-depth tables padded to bucketed lengths, as numpy arrays
    (the ladder's input; ``device_tables`` moves them to a device)."""
    ensure_frames(p)
    if info is None:
        info = info_dims(p)
    c_pad, ni_pad, i_tab = info

    def padded(a, rows=r_pad):
        out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
        out[:a.shape[0]] = a
        return out

    def padded_c(a):
        out = np.zeros((c_pad,), dtype=a.dtype)
        out[:p.C] = a
        return out

    def padded_ri(a):
        out = np.zeros((r_pad, i_tab) + a.shape[2:], dtype=a.dtype)
        out[:a.shape[0], :p.I] = a
        return out

    t = {
        "shift": padded(p.shift), "static_ok": padded(p.static_ok),
        "f_code": padded(p.f_code), "a1": padded(p.a1), "a2": padded(p.a2),
        "ver": padded(p.ver), "pred_frame": padded(p.pred_frame),
        "upd_mask": padded(p.upd_mask), "u_forced": padded(p.u_forced),
        "ceil_frame": padded(p.ceil_frame),
        "ceil_beyond": padded(p.ceil_beyond),
    }
    # ceiling padding must be +inf, not 0 (a zero ceiling would prune
    # clamped-gather rows)
    t["ceil_frame"][p.ceil_frame.shape[0]:] = 2 ** 30
    t["ceil_beyond"][p.ceil_beyond.shape[0]:] = 2 ** 30
    if c_pad:
        inc = np.zeros((c_pad, ni_pad), dtype=np.uint32)
        inc[np.arange(p.C), p.c_word] = \
            np.uint32(1) << p.c_shift.astype(np.uint32)
        t.update({
            "c_f": padded_c(p.c_f), "c_a1": padded_c(p.c_a1),
            "c_a2": padded_c(p.c_a2), "c_size": padded_c(p.c_size),
            "c_off": padded_c(p.c_off), "c_word": padded_c(p.c_word),
            "c_shift": padded_c(p.c_shift), "c_mask": padded_c(p.c_mask),
            "c_inc": inc,
            "i_static_ok": padded_ri(p.i_static_ok),
            "ipred_frame": padded_ri(p.ipred_frame),
        })
    return t


def device_tables(p: Packed, dev: torch.device) -> dict:
    """``pad_tables`` on ``dev``: bool tables stay bool, every integer
    table (uint32 words included, unsigned) becomes int64."""
    out = {}
    for k, v in pad_tables(p, bucket(p.R)).items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(
            a if a.dtype == bool else a.astype(np.int64)).to(dev)
    return out


def _lex_order(keys: list) -> torch.Tensor:
    """The permutation that sorts rows lexicographically by ``keys``
    (1-D int64 tensors of 32-bit values, most significant first; int32
    keys biased by 2**31 so their signed order holds). Keys pair into
    int64s two at a time, then stable sorts chain from the least
    significant pair up — ``lax.sort(ops, num_keys=len(ops))``."""
    pairs = []
    for j in range(0, len(keys), 2):
        if j + 1 < len(keys):
            pairs.append((keys[j] - 2 ** 31) * 2 ** 32 + keys[j + 1])
        else:
            pairs.append(keys[j])
    perm = None
    for key in reversed(pairs):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _expand(dvec, wvec, ivec, vvec, tables, R: int, I: int, w: int,
            f_out: int):
    """One BFS wave: expand a frontier into its deduped successor set,
    truncated to ``f_out`` rows.

    Frontier: dvec [F] depths, wvec [F, NW] uint32 mask words, ivec
    [F, NI] uint32 info count words, vvec [F] value ids, all int64 on
    the tables' device; sentinel rows mark empty slots. Returns (out_d,
    out_w, out_i, out_v, n_new, accepted), the last two as 0-d tensors.
    ``accepted`` is computed on the full candidate set before
    truncation, so a reached goal is never lost to overflow."""
    from .wgl_mxu import _popcount32

    dev = dvec.device
    f_in = dvec.shape[0]
    nw = wvec.shape[1]
    bit = torch.arange(w, device=dev)
    B = torch.where(bit[:, None] // 32 == torch.arange(nw, device=dev),
                    1 << (bit[:, None] % 32), 0)           # [W, NW]

    alive = (dvec != SENTINEL_D) & (dvec < R)              # [F]
    d_cl = dvec.clamp(0, tables["shift"].shape[0] - 1)

    def row(name):
        return tables[name][d_cl]

    s_ok = row("static_ok")                                # [F, W]
    fc = row("f_code")
    ra1 = row("a1")
    ra2 = row("a2")
    rver = row("ver")
    rpred = row("pred_frame")                              # [F, W, NW]
    rupd = row("upd_mask")                                 # [F, NW]
    ruf = row("u_forced")                                  # [F]
    rshift = row("shift")                                  # [F]

    wm = wvec[:, None, :]                                  # [F, 1, NW]
    not_set = ~((wm & B[None]) != 0).any(-1)               # [F, W]
    preds_in = ((wm & rpred) == rpred).all(-1)             # [F, W]
    ni = ivec.shape[1]
    c_pad = tables["c_size"].shape[-1] if ni else 0
    if c_pad:
        cw = tables["c_word"].clamp(0, ni - 1)             # [C]
        counts = (ivec[:, cw] >> tables["c_shift"][None, :]) \
            & tables["c_mask"][None, :]                    # [F, C]
        info_total = counts.sum(1)                         # [F]
    else:
        info_total = 0
    version = ruf + _popcount32(wvec & rupd).sum(-1) + info_total
    # dead-state prune: version never decreases, so a state whose
    # version exceeds the min ceiling among unlinearized required ops
    # can never linearize them
    min_ceil = torch.minimum(
        torch.where(not_set, row("ceil_frame"), 2 ** 30).amin(1),
        row("ceil_beyond"))                                # [F]
    alive = alive & (version <= min_ceil)
    ver_b = version[:, None]
    v = vvec[:, None]                                      # [F, 1]

    is_read = fc == READ
    is_write = fc == WRITE
    is_cas = fc == CAS
    no_assert = rver == NO_ASSERT
    ver_ok = torch.where(is_read, no_assert | (rver == ver_b),
                         no_assert | (rver == ver_b + 1))
    read_ok = is_read & ((ra1 == WILDCARD) | (ra1 == v))
    cas_ok = is_cas & (ra1 == v)
    model_ok = read_ok | is_write | cas_ok
    req_valid = (alive[:, None] & s_ok & not_set & preds_in & ver_ok
                 & model_ok)

    new_w = wm | B[None]                                   # [F, W, NW]
    # slide feasibility: the rshift lowest bits (which fall off the
    # window) must all be set; shift amounts are clamped so no lane
    # shifts by >= 32
    s_amt = rshift[:, None]                                # [F, 1]

    def low_mask_word(wi):
        k = (s_amt - 32 * wi).clamp(0, 32)
        ksafe = k.clamp(max=31)
        return torch.where(k >= 32, _M32, (1 << ksafe) - 1)

    low = torch.stack([low_mask_word(wi) for wi in range(nw)], -1)
    slide_ok = ((new_w & low) == low).all(-1)              # [F, W]
    req_valid = req_valid & slide_ok

    def rshift_words(words, s):
        """Shift the NW-word value right by s in [0, 32*nw], word-wise
        with clamped lane shifts (s = 32*k + r)."""
        k = s >> 5
        r = s & 31
        rsafe = r.clamp(max=31)
        carry_amt = (32 - rsafe).clamp(max=31)
        zero = torch.zeros_like(words[0])
        padded = list(words) + [zero] * (nw + 1)
        out = []
        for i in range(nw):
            lo_w = zero
            hi_w = zero
            for kk in range(nw + 1):
                lo_w = torch.where(k == kk, padded[i + kk], lo_w)
                hi_w = torch.where(k == kk, padded[i + kk + 1], hi_w)
            carry = torch.where(r == 0, 0, (hi_w << carry_amt) & _M32)
            out.append((lo_w >> rsafe) | carry)
        return out

    new_w = torch.stack(rshift_words([new_w[:, :, wi] for wi in range(nw)],
                                     s_amt), -1)           # [F, W, NW]
    req_d = (dvec[:, None] + 1).expand(f_in, w)
    req_i = ivec[:, None, :].expand(f_in, w, ni)
    req_v = torch.where(is_read, v, torch.where(is_write, ra1, ra2))
    accepted = (req_valid & (req_d == R)).any()

    rv3 = req_valid[:, :, None]
    cand_d = [torch.where(req_valid, req_d, SENTINEL_D)]
    cand_w = [torch.where(rv3, new_w, SENTINEL_W)]
    cand_i = [req_i]
    cand_v = [torch.where(req_valid, req_v, SENTINEL_V)]

    if c_pad:
        # class candidates: fire each class's NEXT member (the count-th
        # in canonical order); the count field increments in place
        can_more = counts < tables["c_size"][None, :]
        i_tab = tables["i_static_ok"].shape[-1]
        member = (tables["c_off"][None, :] + counts).clamp(0, i_tab - 1)
        # one advanced-index gather straight to [F, C(, NW)]
        istat = tables["i_static_ok"][d_cl[:, None], member]   # [F, C]
        ipredf = tables["ipred_frame"][d_cl[:, None], member]  # [F, C, NW]
        ipred_in = ((wm & ipredf) == ipredf).all(-1)            # [F, C]
        cfc = tables["c_f"][None, :]
        ca1 = tables["c_a1"][None, :]
        ca2 = tables["c_a2"][None, :]
        c_is_w = cfc == WRITE
        i_model_ok = c_is_w | ((cfc == CAS) & (ca1 == v))
        i_valid = (alive[:, None] & can_more & istat & ipred_in
                   & i_model_ok
                   # the child (version+1, same required set) would be
                   # ceiling-dead: don't spend a frontier slot on it
                   & ((version + 1) <= min_ceil)[:, None])
        i_new_i = (ivec[:, None, :] + tables["c_inc"][None, :, :]) & _M32
        i_new_v = torch.where(c_is_w, ca1, ca2).expand(f_in, c_pad)
        cand_d.append(torch.where(i_valid,
                                  dvec[:, None].expand(f_in, c_pad),
                                  SENTINEL_D))
        cand_w.append(torch.where(i_valid[:, :, None],
                                  wvec[:, None, :].expand(f_in, c_pad, nw),
                                  SENTINEL_W))
        cand_i.append(torch.where(i_valid[:, :, None], i_new_i,
                                  ivec[:, None, :].expand(f_in, c_pad, ni)))
        cand_v.append(torch.where(i_valid, i_new_v, SENTINEL_V))

    flat_d = torch.cat(cand_d, 1).reshape(-1)
    n_cand = flat_d.shape[0]
    flat_w = torch.cat(cand_w, 1).reshape(n_cand, nw)
    flat_i = torch.cat(cand_i, 1).reshape(n_cand, ni)
    flat_v = torch.cat(cand_v, 1).reshape(-1)

    keys = ([flat_d + 2 ** 31] + [flat_w[:, wi] for wi in range(nw)]
            + [flat_i[:, iw] for iw in range(ni)] + [flat_v + 2 ** 31])
    perm = _lex_order(keys)
    sd = flat_d[perm]
    sw = flat_w[perm]
    si = flat_i[perm]
    sv = flat_v[perm]
    is_real = sd != SENTINEL_D
    change = ((sd[1:] != sd[:-1]) | (sv[1:] != sv[:-1])
              | (sw[1:] != sw[:-1]).any(1) | (si[1:] != si[:-1]).any(1))
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       change])
    uniq = is_real & first
    pos = torch.cumsum(uniq.to(torch.int64), 0) - 1
    n_new = uniq.sum()
    # slot f_out of an f_out + 1 buffer collects the dropped rows
    pos = torch.where(uniq & (pos < f_out), pos, f_out)
    i64 = torch.int64
    out_d = torch.full((f_out + 1,), SENTINEL_D, dtype=i64, device=dev)
    out_w = torch.full((f_out + 1, nw), SENTINEL_W, dtype=i64, device=dev)
    out_i = torch.zeros((f_out + 1, ni), dtype=i64, device=dev)
    out_v = torch.full((f_out + 1,), SENTINEL_V, dtype=i64, device=dev)
    out_d[pos] = sd
    out_w[pos] = sw
    if ni:
        out_i[pos] = si
    out_v[pos] = sv
    return (out_d[:f_out], out_w[:f_out], out_i[:f_out], out_v[:f_out],
            n_new, accepted)


def _initial_frontier(f: int, nw: int, ni: int, dev: torch.device):
    """The search's start: one state at depth 0 with nothing linearized
    and the key unset, then f - 1 empty slots; n_alive = 1."""
    i64 = torch.int64
    d0 = torch.full((f,), SENTINEL_D, dtype=i64, device=dev)
    d0[0] = 0
    w0 = torch.full((f, nw), SENTINEL_W, dtype=i64, device=dev)
    w0[0] = 0
    i0 = torch.zeros((f, ni), dtype=i64, device=dev)
    v0 = torch.full((f,), SENTINEL_V, dtype=i64, device=dev)
    v0[0] = NONE_VAL
    return d0, w0, i0, v0, torch.ones((), dtype=i64, device=dev)


def _grow(frontier, f_next: int):
    """Pad a frozen frontier with empty slots up to the next rung."""
    dvec, wvec, ivec, vvec, n_alive = frontier
    grow = f_next - dvec.shape[0]
    dev = dvec.device
    i64 = torch.int64
    return (torch.cat([dvec, torch.full((grow,), SENTINEL_D, dtype=i64,
                                        device=dev)]),
            torch.cat([wvec, torch.full((grow, wvec.shape[1]), SENTINEL_W,
                                        dtype=i64, device=dev)]),
            torch.cat([ivec, torch.zeros((grow, ivec.shape[1]), dtype=i64,
                                         device=dev)]),
            torch.cat([vvec, torch.full((grow,), SENTINEL_V, dtype=i64,
                                        device=dev)]),
            n_alive)


def _wgl_loop(tables: dict, R: int, I: int, f_max: int, w: int, init0,
              k_stop: Optional[int] = None):
    """The wave loop at one rung, resumed from ``init0 = (k0, dvec,
    wvec, ivec, vvec, n_alive)``: expand until accepted, a dead
    frontier, overflow (the pre-expansion frontier is frozen for the
    next rung or the spill) or ``k_stop`` waves (the streaming pause;
    None keeps the R + I + 1 exhaustion bound).

    Every carry is masked by ``active`` (the reference's vmap-safety
    guard), so waves run past the end are no-ops: the host reads the
    loop condition only every ``SYNC_EVERY`` waves, and on the card a
    long run replays batches of waves from a CUDA graph
    (``_graph_waves``). Returns (accepted, overflow, k, peak, frontier)
    with the first four as Python values and the frontier's tensors on
    the device."""
    k0, dvec, wvec, ivec, vvec, n_alive = init0
    dev = dvec.device
    lim = (R + I + 1) if k_stop is None else min(k_stop, R + I + 1)
    i64 = torch.int64
    n_alive = torch.as_tensor(n_alive, dtype=i64, device=dev)
    # carry: k, dvec, wvec, ivec, vvec, n_alive, peak, overflow, accepted
    carry = [torch.tensor(k0, dtype=i64, device=dev), dvec, wvec, ivec,
             vvec, n_alive, n_alive.clone(),
             torch.zeros((), dtype=torch.bool, device=dev),
             torch.tensor(R == 0, device=dev)]

    def running(c):
        k, n_alive, overflow, accepted = c[0], c[5], c[7], c[8]
        return (~accepted) & (n_alive > 0) & (~overflow) & (k < lim)

    def wave(c):
        k, dvec, wvec, ivec, vvec, n_alive, peak, overflow, accepted = c
        active = running(c)
        out_d, out_w, out_i, out_v, n_new, acc_now = _expand(
            dvec, wvec, ivec, vvec, tables, R, I, w, f_max)
        ovf_now = (n_new > f_max) & (~acc_now)
        advance = active & (~ovf_now)
        return [torch.where(advance, k + 1, k),
                torch.where(advance, out_d, dvec),
                torch.where(advance, out_w, wvec),
                torch.where(advance, out_i, ivec),
                torch.where(advance, out_v, vvec),
                torch.where(advance, torch.clamp(n_new, max=f_max),
                            n_alive),
                torch.where(active, torch.maximum(peak, n_new), peak),
                torch.where(active, overflow | ovf_now, overflow),
                torch.where(active, accepted | acc_now, accepted)]

    # each active wave advances k or stops the loop, so lim - k0 waves
    # always suffice
    n_waves = max(0, lim - k0)
    done = 0
    if dev.type == "cuda" and n_waves >= GRAPH_MIN_WAVES:
        carry, done = _graph_waves(wave, running, carry, n_waves)
    for it in range(done, n_waves):
        if (it - done) % SYNC_EVERY == 0 and not bool(running(carry)):
            break
        carry = wave(carry)
    k, dvec, wvec, ivec, vvec, n_alive, peak, overflow, accepted = carry
    return (bool(accepted), bool(overflow), int(k), int(peak),
            (dvec, wvec, ivec, vvec, n_alive))


def _graph_waves(wave, running, carry: list, n_waves: int):
    """Run waves on the card from one captured CUDA graph of
    ``GRAPH_WAVES`` waves, replayed while the loop runs and whole
    batches fit in ``n_waves``: the same operations as the eager loop
    (so the same results), without the host's per-operation launch
    cost. Returns (carry, waves run); the caller runs the rest."""
    static = [c.clone() for c in carry]
    side = torch.cuda.Stream(device=static[0].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # one eager wave first, as CUDA graphs want before a capture
        for dst, src in zip(static, wave(static)):
            dst.copy_(src)
    torch.cuda.current_stream().wait_stream(side)
    done = 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = static
        for _ in range(GRAPH_WAVES):
            c = wave(c)
        for dst, src in zip(static, c):
            dst.copy_(src)
    while done + GRAPH_WAVES <= n_waves and bool(running(static)):
        graph.replay()
        done += GRAPH_WAVES
    return static, done


def _ladder(p: Packed, f_max: Optional[int]) -> list:
    """The rungs a search climbs: from ``f_max`` (default the bottom
    rung) up; W=128 windows stop at F_MAX and skip 256, as in the
    reference (their overflows are almost always combinatorial blowup,
    which the DFS-first overflow path takes)."""
    ladder = LADDER if f_max is None else \
        [f_max] + [f for f in LADDER if f > f_max]
    if p.w == W_MAX:
        ladder = [f for f in ladder if f <= F_MAX and f != 256] \
            or [ladder[0]]
    return ladder


def _overflow_result(p: Packed, peak: int, rungs: int, resume) -> dict:
    return {"valid?": "unknown", "overflow": True,
            "reason": "frontier overflow past the top rung",
            "peak-frontier": peak, "ops": p.R, "info-ops": p.I,
            "rungs": rungs, "engine": "jnp-ladder", "_resume": resume}


def _spilled_result(p: Packed, tables, frontier, k: int, peak: int,
                    rungs: int) -> dict:
    out = spill_packed(p, tables, frontier, k)
    out["peak-frontier"] = max(peak, out.get("peak-frontier", 0))
    out["rungs"] = rungs
    out.setdefault("engine", "jnp-ladder")
    return out


def _ladder_result(p: Packed, valid: bool, k: int, peak: int,
                   rungs: int) -> dict:
    return {"valid?": valid, "waves": k, "peak-frontier": peak,
            "ops": p.R, "info-ops": p.I, "rungs": rungs,
            "engine": "jnp-ladder",
            **({} if valid else {"stuck-at-depth": k})}


def check_packed(p: Packed, f_max: Optional[int] = None,
                 spill: bool = True, device=None) -> dict:
    """Check one packed history on ``device`` (``cuda`` unless named).

    With ``f_max`` None the wave kernel (ops/wgl_mxu.py) goes first; a
    history it cannot take (info ops, id budget) or whose frontier
    overflows its 32 slots climbs the capacity ladder from rung 32. On
    overflow the frozen pre-expansion frontier resumes at the next rung
    (earlier waves are never redone). Past the top rung the spill BFS
    takes over from the same frontier — unless ``spill=False``, which
    returns ``{"valid?": "unknown", "overflow": True, "_resume": ...}``
    so the caller can try the DFS first and then ``spill_packed(p,
    *out["_resume"])``. A wave-kernel failure on the card raises."""
    dev = resolve_device(device)
    if not p.ok:
        return {"valid?": "unknown", "reason": p.reason,
                "blowup": p.blowup}
    if p.R == 0:
        return {"valid?": True, "waves": 0}
    if f_max is None:
        from . import wgl_mxu
        out = wgl_mxu.check_packed_mxu(p, device=dev)
        if out is not None and not out.get("overflow"):
            return out
    ladder = _ladder(p, f_max)
    ni = info_dims(p)[1]
    tables = device_tables(p, dev)
    valid, overflow, k, peak, frontier = _wgl_loop(
        tables, p.R, p.I, ladder[0], p.w,
        (0, *_initial_frontier(ladder[0], p.w // 32, ni, dev)))
    peak_all = max(1, peak)
    rungs = 1
    for f_next in ladder[1:]:
        if not overflow:
            break
        rungs += 1
        valid, overflow, k, peak, frontier = _wgl_loop(
            tables, p.R, p.I, f_next, p.w, (k, *_grow(frontier, f_next)))
        peak_all = max(peak_all, peak)
    if overflow:
        if not spill:
            return _overflow_result(p, peak_all, rungs,
                                    (tables, frontier, k))
        return _spilled_result(p, tables, frontier, k, peak_all, rungs)
    return _ladder_result(p, valid, k, peak_all, rungs)


def spill_packed(p: Packed, tables, frontier, waves_done: int) -> dict:
    """Budgeted spill continuation from a frozen frontier — the entry
    point for resuming a ``check_packed(..., spill=False)`` overflow
    (its ``_resume`` payload) without re-climbing the ladder."""
    return _spill_bfs(p, tables, frontier, waves_done,
                      state_budget=SPILL_STATE_BUDGET
                      if p.I < SPILL_I_LIMIT
                      else SPILL_STATE_BUDGET_HIGH_I)


def _spill_bfs(p: Packed, tables, frontier, waves_done: int,
               state_budget: int = SPILL_STATE_BUDGET,
               wall_budget_s: float = SPILL_WALL_BUDGET_S) -> dict:
    """Host-driven chunked BFS after the ladder's top rung overflowed.

    The frontier lives on the host as int64 rows (d, w-words, i-words,
    v); each wave expands it on the device in SPILL_CHUNK-row chunks at
    full output capacity (a chunk of f_in rows has at most f_in * (W +
    classes) successors, so nothing is dropped), then merges the chunks
    with ``np.unique`` over rows. Sound and complete: the only exits
    without a verdict are the explicit state, frontier and wall
    budgets."""
    c_pad, ni, _ = info_dims(p)
    nw = p.w // 32
    dev = tables["shift"].device
    f_in = SPILL_CHUNK if p.w < W_MAX else 1024
    width = p.w + max(c_pad, 1)
    dvec, wvec, ivec, vvec, n_alive = frontier
    n = int(n_alive)
    fr = torch.cat([dvec[:n, None], wvec[:n], ivec[:n], vvec[:n, None]],
                   1).cpu().numpy()                    # [n, 2 + nw + ni]
    t_start = time.monotonic()
    states_total = n
    peak = n
    waves = waves_done
    max_waves = p.R + p.I + 1
    while fr.shape[0] and waves < max_waves:
        if time.monotonic() - t_start > wall_budget_s:
            return {"valid?": "unknown", "blowup": True,
                    "reason": f"spill wall budget {wall_budget_s:.0f}s "
                              "exceeded",
                    "peak-frontier": peak, "spilled": True}
        succs = []
        for s in range(0, fr.shape[0], f_in):
            chunk = torch.from_numpy(fr[s:s + f_in]).to(dev)
            out_d, out_w, out_i, out_v, n_new, accepted = _expand(
                chunk[:, 0], chunk[:, 1:1 + nw],
                chunk[:, 1 + nw:1 + nw + ni],
                chunk[:, 1 + nw + ni], tables, p.R, p.I, p.w,
                chunk.shape[0] * width)
            if bool(accepted):
                return {"valid?": True, "waves": waves + 1,
                        "peak-frontier": peak, "ops": p.R,
                        "info-ops": p.I, "spilled": True,
                        "states": states_total}
            m = int(n_new)
            if m:
                succs.append(torch.cat(
                    [out_d[:m, None], out_w[:m], out_i[:m],
                     out_v[:m, None]], 1).cpu().numpy())
        if not succs:
            fr = np.zeros((0, 2 + nw + ni), dtype=np.int64)
            break
        fr = np.unique(np.concatenate(succs, axis=0), axis=0)
        waves += 1
        states_total += fr.shape[0]
        peak = max(peak, fr.shape[0])
        if fr.shape[0] > SPILL_FRONTIER_LIMIT:
            return {"valid?": "unknown", "blowup": True,
                    "reason": f"spill frontier {fr.shape[0]} > "
                              f"{SPILL_FRONTIER_LIMIT}",
                    "peak-frontier": peak, "spilled": True}
        if states_total > state_budget:
            return {"valid?": "unknown", "blowup": True,
                    "reason": f"spill budget exceeded "
                              f"({states_total} states)",
                    "peak-frontier": peak, "spilled": True}
    if fr.shape[0]:
        # the wave backstop tripped with work remaining: cannot happen
        # for a well-formed pack (levels are bounded by R + I)
        return {"valid?": "unknown", "reason": "spill wave budget exceeded",
                "peak-frontier": peak, "spilled": True}
    return {"valid?": False, "waves": waves, "peak-frontier": peak,
            "ops": p.R, "info-ops": p.I, "spilled": True,
            "states": states_total, "stuck-at-depth": waves}


class FrontierState:
    """Resumable cursor for :func:`check_prefix`: the device tables, the
    frozen pre-expansion frontier, the cumulative wave counter, the
    current ladder rung and the run accounting. ``done`` flips once the
    search concludes; ``result`` then holds the same dict the one-shot
    ladder produces."""

    __slots__ = ("p", "tables", "ladder", "rung_i", "k", "frontier",
                 "peak", "rungs", "waves_run", "done", "result", "spill")

    def __init__(self):
        self.done = False
        self.result = None
        self.waves_run = 0


def check_prefix(p: Packed, state: Optional[FrontierState] = None,
                 max_waves: int = 64, spill: bool = True,
                 device=None) -> FrontierState:
    """Chunked form of the ladder: advance the BFS by at most
    ``max_waves`` waves and return the (possibly finished) state. Call
    with ``state=None`` to start (on ``device``, ``cuda`` unless named);
    poll ``state.done`` / ``state.result``.

    The wave budget only chooses where the loop pauses: frontier
    contents, rung escalations, the spill hand-off and the final dict
    equal the one-shot ladder's for every budget. The wave kernel is not
    tried here (pausing is a host-driven loop by construction)."""
    if state is None:
        dev = resolve_device(device)
        state = FrontierState()
        state.p = p
        state.spill = spill
        if not p.ok:
            state.done = True
            state.result = {"valid?": "unknown", "reason": p.reason,
                            "blowup": p.blowup}
            return state
        if p.R == 0:
            state.done = True
            state.result = {"valid?": True, "waves": 0}
            return state
        state.ladder = _ladder(p, None)
        state.tables = device_tables(p, dev)
        state.rung_i = 0
        state.frontier = _initial_frontier(state.ladder[0], p.w // 32,
                                           info_dims(p)[1], dev)
        state.k = 0
        state.peak = 1
        state.rungs = 1
    if state.done:
        return state
    p = state.p
    k_before = state.k
    valid, overflow, k, peak, frontier = _wgl_loop(
        state.tables, p.R, p.I, state.ladder[state.rung_i], p.w,
        (k_before, *state.frontier),
        k_stop=k_before + max(1, max_waves))
    state.peak = max(state.peak, peak)
    state.k, state.frontier = k, frontier
    state.waves_run += k - k_before
    if overflow:
        if state.rung_i + 1 < len(state.ladder):
            # climb one rung: pad the frozen frontier in place, exactly
            # like the one-shot ladder
            state.rung_i += 1
            state.rungs += 1
            state.frontier = _grow(frontier, state.ladder[state.rung_i])
            return state
        state.done = True
        if state.spill:
            state.result = _spilled_result(p, state.tables, state.frontier,
                                           state.k, state.peak, state.rungs)
        else:
            state.result = _overflow_result(
                p, state.peak, state.rungs,
                (state.tables, state.frontier, state.k))
        return state
    if valid or int(frontier[4]) == 0 or k >= p.R + p.I + 1:
        state.done = True
        state.result = _ladder_result(p, valid, k, state.peak, state.rungs)
    return state
